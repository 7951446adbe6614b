"""Parity of the port's one-shot sketch stage (candidates, sketch, heavy
hitters, pipeline._sketch_stage_impl) with the JAX reference, bit for bit
given the same hash parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import candidates as ref_cand
from repro.core import heavy_hitters as ref_hh
from repro.core import pipeline as ref_pipeline
from repro.core import sketch as ref_sketch
from repro.data.synthetic import MixtureSpec, gaussian_mixture
from repro_torch import carry
from repro_torch.core import candidates, heavy_hitters, pipeline, sketch, u64


def _eq(ref, port, what=""):
    np.testing.assert_array_equal(
        np.asarray(ref).astype(np.float64), port.cpu().numpy().astype(
            np.float64), err_msg=what)


def _tied_keys(seed, n_keys=300, hi_zero=False):
    """Keys whose counts are small integers, so many ties sit at any
    top-k boundary; hi limb zero or spread."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, size=n_keys, dtype=np.uint64)
    hi = np.zeros(n_keys, np.uint64) if hi_zero else \
        rng.integers(0, 4, size=n_keys, dtype=np.uint64)
    reps = rng.integers(1, 4, size=n_keys)
    idx = rng.permutation(np.repeat(np.arange(n_keys), reps))
    return hi[idx].astype(np.uint32), lo[idx].astype(np.uint32)


@pytest.mark.parametrize("hi_zero", [True, False])
def test_sorted_runs_and_topk_ties_bit_identical(hi_zero):
    hi, lo = _tied_keys(1, hi_zero=hi_zero)
    ref = ref_cand.sorted_runs(jnp.asarray(hi), jnp.asarray(lo),
                               assume_hi_zero=hi_zero)
    port = candidates.sorted_runs(u64.from_numpy(hi), u64.from_numpy(lo),
                                  assume_hi_zero=hi_zero)
    for f in ref._fields:
        _eq(getattr(ref, f), getattr(port, f), f)
    # k = 50 cuts through a band of equal counts: lax.top_k's
    # lower-index-first rule decides which keys survive
    for k in (50, 1000):
        rc, rd = ref_cand.topk_from_runs(ref, k, return_dropped=True)
        pc, pd = candidates.topk_from_runs(port, k, return_dropped=True)
        for f in rc._fields:
            _eq(getattr(rc, f), getattr(pc, f), f"k={k} {f}")
        assert float(rd) == float(pd)


def test_topk_desc_matches_lax_top_k_total_order():
    x = np.array([0.0, -0.0, 2.0, -np.inf, 2.0, -0.0, 1.0, -np.inf, 0.0],
                 np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 9)
    pv, pi = candidates.topk_desc(torch.from_numpy(x), 9)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_array_equal(np.signbit(np.asarray(rv)),
                                  np.signbit(pv.numpy()))


def test_median_matches_jnp_median():
    """torch.median returns the lower middle value; jnp.median the mean
    of the two (2.5, not 2.0, on [1, 2, 3, 4])."""
    rng = np.random.default_rng(2)
    for rows in (1, 4, 5, 16):
        x = rng.integers(-5, 6, size=(rows, 64)).astype(np.float32)
        _eq(jnp.median(jnp.asarray(x), axis=0),
            sketch.median_rows(torch.from_numpy(x)))
    assert float(sketch.median_rows(torch.tensor([[1.], [2.], [3.], [4.]]))
                 ) == 2.5


@pytest.mark.parametrize("column", [
    [0.0, -0.0, -0.0, 5.0], [-0.0, -0.0, 0.0, 5.0],
    [5.0, 0.0, -0.0, -0.0, -3.0, 0.0]])
def test_median_rows_signed_zeros_match_jnp_median(column):
    """−0.0 and +0.0 compare equal and keep their row order in both
    sorts, so the sign of a zero median follows the rows' order: by int32
    view, [0, −0, −0, 5] gives −0.0 and [−0, −0, 0, 5] gives +0.0."""
    x = np.array(column, np.float32)[:, None]
    want = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    got = sketch.median_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_median_rows_signed_zeros_at_r16():
    """64 columns of R = 16: ten zeros of random signs around the middle
    ranks, three values on each side."""
    rng = np.random.default_rng(4)
    base = np.array([-3, -2, -1, 1, 2, 3] + [0] * 10, np.float32)
    x = np.stack([rng.permutation(base) for _ in range(64)], axis=1)
    x[x == 0] *= rng.choice([-1.0, 1.0], size=int((x == 0).sum()))
    want = np.asarray(jnp.median(jnp.asarray(x), axis=0))
    got = sketch.median_rows(torch.from_numpy(x)).numpy()
    assert np.signbit(want).any() and not np.signbit(want).all()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_sketch_table_and_estimates_bit_identical():
    hi, lo = _tied_keys(3)
    params = par.hash_params(5, 8)
    ref_sk = ref_sketch.init(jax.random.key(5), 8, 9)
    ref_sk = ref_sketch.update_runs(
        ref_sk, ref_cand.sorted_runs(jnp.asarray(hi), jnp.asarray(lo)))
    sk = sketch.init(carry.hash_params_from_numpy(*params), 9)
    sk = sketch.update_runs(sk, candidates.sorted_runs(u64.from_numpy(hi),
                                                       u64.from_numpy(lo)))
    _eq(ref_sk.table, sk.table, "table")
    _eq(ref_sketch.estimate(ref_sk, jnp.asarray(hi), jnp.asarray(lo)),
        sketch.estimate(sk, u64.from_numpy(hi), u64.from_numpy(lo)))
    # candidates with duplicates and padding; k cuts through ties
    ch = np.concatenate([hi[:80], hi[:20], np.full(10, 0xFFFFFFFF, np.uint32)])
    cl = np.concatenate([lo[:80], lo[:20], np.full(10, 0xFFFFFFFF, np.uint32)])
    cm = np.arange(110) < 100
    for k in (30, 200):
        ref = ref_sketch.topk_from_candidates(
            ref_sk, jnp.asarray(ch), jnp.asarray(cl), k,
            cand_mask=jnp.asarray(cm))
        port = sketch.topk_from_candidates(
            sk, u64.from_numpy(ch), u64.from_numpy(cl), k,
            cand_mask=torch.from_numpy(cm))
        for r, p in zip(ref, port):
            _eq(r, p, f"k={k}")


def test_extract_bit_identical():
    """heavy_hitters.extract: exact local top-pool, then sketch top-k."""
    hi, lo = _tied_keys(4)
    params = par.hash_params(6, 4)
    ref_sk = ref_sketch.update(ref_sketch.init(jax.random.key(6), 4, 8),
                               jnp.asarray(hi), jnp.asarray(lo))
    sk = sketch.update(sketch.init(carry.hash_params_from_numpy(*params), 8),
                       u64.from_numpy(hi), u64.from_numpy(lo))
    _eq(ref_sk.table, sk.table, "table")
    ref = ref_hh.extract(ref_sk, jnp.asarray(hi), jnp.asarray(lo), 40)
    port = heavy_hitters.extract(sk, u64.from_numpy(hi), u64.from_numpy(lo),
                                 40)
    for f in ref._fields:
        _eq(getattr(ref, f), getattr(port, f), f)


@pytest.mark.parametrize("dims,bins,top_k,pool", [
    (4, 8, 64, 0),       # 12-bit keys: the low-limb sort
    (8, 25, 200, 0),     # 40-bit keys: the two-limb sort
    (4, 8, 64, 100),     # explicit candidate pool
])
def test_sketch_stage_bit_identical(dims, bins, top_k, pool):
    pts, _ = gaussian_mixture(5000, MixtureSpec(dims=dims), seed=dims)
    ref_cfg = ref_pipeline.SnsConfig(bins=bins, rows=4, log2_cols=10,
                                     top_k=top_k, candidate_pool=pool)
    cfg = pipeline.SnsConfig(**{f.name: getattr(ref_cfg, f.name) for f in
                                dataclasses.fields(ref_cfg)
                                if f.name != "kernel_mode"})
    rgrid, rhh, rdrop = ref_pipeline._sketch_stage_impl(
        ref_cfg, jnp.asarray(pts), None, None, ("data",))
    hp = carry.hash_params_from_numpy(*par.hash_params(cfg.seed, cfg.rows))
    grid, hh, drop = pipeline._sketch_stage_impl(cfg, pts, None,
                                                 device="cpu",
                                                 hash_params=hp)
    assert (grid.lo, grid.hi) == (rgrid.lo, rgrid.hi)
    for f in rhh._fields:
        _eq(getattr(rhh, f), getattr(hh, f), f)
    assert rdrop == drop
    g2, hh2 = pipeline.sketch_stage(cfg, pts, device="cpu", hash_params=hp)
    for a, b in zip(hh, hh2):
        assert torch.equal(a, b)
