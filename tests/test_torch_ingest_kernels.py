"""The fused-ingest entry points and the reservoir merge against the JAX
reference, on the CPU.

The port's ``kernels/ops.py`` wrappers run the plain twins of K6
``hash_points``, K7 ``sketch_update_table`` and K8
``sketch_estimate_table`` here; the reference's wrappers run its Pallas
kernels in interpret mode (as tests/test_kernels.py does), and its
``kernels/ref.py`` oracles and ``core.sketch`` give the ground truth.
Both packages take the same hash parameters (the reference's draws,
carried as numpy).  Bars: buckets, signs, integer tables, estimates and
reservoirs bit for bit; weighted tables within atol 1e-4 (the reference
test's own bar: its kernel and scatter add in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hash_params
from repro.core import candidates as ref_cand
from repro.core import heavy_hitters as ref_hh
from repro.core import hashing as ref_hashing
from repro.core import quantize as ref_quantize
from repro.core import sketch as ref_sketch
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch import carry
from repro_torch.core import candidates, heavy_hitters, quantize, sketch, u64
from repro_torch.kernels import ops


def _grid(d, bins=16):
    return (ref_quantize.GridSpec(dims=d, bins=bins, lo=np.zeros(d),
                                  hi=np.ones(d)),
            quantize.GridSpec(dims=d, bins=bins, lo=np.zeros(d),
                              hi=np.ones(d)))


def _points(n, d, bins, seed):
    """Uniform points, plus points exactly on bin edges and outside the
    grid (clamped)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 1.1, size=(n, d)).astype(np.float32)
    pts[: n // 4] = (rng.integers(0, bins + 1, size=(n // 4, d))
                     / bins).astype(np.float32)
    pts[0], pts[1] = -5.0, 5.0
    return pts


def _sketches(seed, rows, l2c):
    hp = hash_params(seed, rows)
    ref = ref_sketch.init(jax.random.key(seed), rows, l2c)
    return ref, sketch.init(carry.hash_params_from_numpy(*hp), l2c)


def _keys(rng, n, bits=64):
    keys = rng.integers(0, 2 ** bits, size=n, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo, u64.from_numpy(hi), u64.from_numpy(lo)


@pytest.mark.parametrize("n,d,rows,l2c", [(1000, 8, 8, 14), (64, 12, 16, 22)])
def test_hash_points_matches_reference(n, d, rows, l2c):
    ref_grid, grid = _grid(d)
    pts = _points(n, d, 16, n + d)
    hp = hash_params(d, rows)
    ref_params = ref_hashing.MulShiftParams(*map(jnp.asarray, hp))
    b, s = ops.hash_points(carry.hash_params_from_numpy(*hp), grid,
                           torch.from_numpy(pts), l2c)
    assert b.dtype == s.dtype == torch.int64 and b.shape == (rows, n)
    rb, rs = ref_ops.hash_points(ref_params, ref_grid, jnp.asarray(pts), l2c,
                                 block_items=128)
    ob, os_ = ref_oracle.hash_points(ref_params, ref_grid, jnp.asarray(pts),
                                     l2c)
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(b.numpy(), np.asarray(ob))
    np.testing.assert_array_equal(s.numpy(), np.asarray(os_))


@pytest.mark.parametrize("n,rows,l2c,weighted", [(512, 4, 10, False),
                                                 (700, 8, 16, True)])
def test_sketch_update_fused_matches_reference(n, rows, l2c, weighted):
    rng = np.random.default_rng(1)
    hi, lo, thi, tlo = _keys(rng, n)
    v = rng.normal(size=n).astype(np.float32) if weighted else None
    ref0, sk0 = _sketches(2, rows, l2c)
    # a table that already holds counts: the delta is added to it
    ref0 = ref_sketch.update(ref0, jnp.asarray(hi[:50]), jnp.asarray(lo[:50]))
    sk0 = sketch.update(sk0, thi[:50], tlo[:50])
    tv = None if v is None else torch.from_numpy(v)
    got = ops.sketch_update_fused(sk0, thi, tlo, values=tv).table.numpy()
    want = ref_ops.sketch_update_fused(
        ref0, jnp.asarray(hi), jnp.asarray(lo),
        values=None if v is None else jnp.asarray(v), block_items=128)
    scatter = ref_sketch.update(ref0, jnp.asarray(hi), jnp.asarray(lo),
                                values=None if v is None else jnp.asarray(v))
    port = sketch.update(sk0, thi, tlo, values=tv).table.numpy()
    if weighted:
        for other in (want.table, scatter.table):
            np.testing.assert_allclose(got, np.asarray(other), atol=1e-4)
        np.testing.assert_allclose(port, np.asarray(scatter.table), atol=1e-4)
    else:
        for other in (want.table, scatter.table):
            np.testing.assert_array_equal(got, np.asarray(other))
        np.testing.assert_array_equal(port, got)


def test_sketch_update_fused_rejects_huge_table():
    """C > 2¹⁶ fails in both packages (the reference's VMEM bound, kept
    so the wrapper fails where the reference's does); sketch.update
    takes any C."""
    ref, sk = _sketches(0, 4, 18)
    z = jnp.zeros(4, jnp.uint32)
    with pytest.raises(ValueError, match="2\\^16"):
        ref_ops.sketch_update_fused(ref, z, z)
    zt = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^16"):
        ops.sketch_update_fused(sk, zt, zt)
    assert float(sketch.update(sk, zt, zt).table.abs().sum()) == 4 * 4


@pytest.mark.parametrize("rows", [4, 3])       # even R: mean of middles
def test_sketch_estimate_mxu_matches_reference(rows):
    rng = np.random.default_rng(3)
    hi, lo, thi, tlo = _keys(rng, 3000, bits=32)  # collisions
    hi[:1000], lo[:1000] = hi[0], lo[0]           # one heavy key
    thi, tlo = u64.from_numpy(hi), u64.from_numpy(lo)
    ref0, sk0 = _sketches(4, rows, 9)
    ref1 = ref_sketch.update(ref0, jnp.asarray(hi), jnp.asarray(lo))
    sk1 = sketch.update(sk0, thi, tlo)
    np.testing.assert_array_equal(sk1.table.numpy(), np.asarray(ref1.table))
    q = rng.choice(3000, 300, replace=False)
    got = ops.sketch_estimate_mxu(sk1, thi[q], tlo[q]).numpy()
    want = ref_sketch.estimate(ref1, jnp.asarray(hi[q]), jnp.asarray(lo[q]))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        sketch.estimate(sk1, thi[q], tlo[q]).numpy(), got)
    mxu = ref_ops.sketch_estimate_mxu(ref1, jnp.asarray(hi[q]),
                                      jnp.asarray(lo[q]), block_q=128,
                                      block_c=256)
    np.testing.assert_allclose(got, np.asarray(mxu), rtol=1e-5, atol=1e-3)
    if rows % 2 == 0:                  # the two middle rows differ somewhere
        assert not np.array_equal(got, np.floor(got))


def test_sketch_extras_match_reference():
    """update_sorted ≡ update, merge, l2_estimate and exact_counts."""
    rng = np.random.default_rng(5)
    hi, lo, thi, tlo = _keys(rng, 800, bits=34)
    hi[::3], lo[::3] = hi[1], lo[1]
    thi, tlo = u64.from_numpy(hi), u64.from_numpy(lo)
    mask = rng.uniform(size=800) < 0.8
    ref0, sk0 = _sketches(6, 5, 8)
    a = sketch.update_sorted(sk0, thi, tlo, mask=torch.from_numpy(mask))
    ra = ref_sketch.update_sorted(ref0, jnp.asarray(hi), jnp.asarray(lo),
                                  mask=jnp.asarray(mask))
    np.testing.assert_array_equal(a.table.numpy(), np.asarray(ra.table))
    np.testing.assert_array_equal(
        a.table.numpy(),
        sketch.update(sk0, thi, tlo, mask=torch.from_numpy(mask)).table)
    m = sketch.merge(a, sketch.update(sk0, thi[:99], tlo[:99]))
    rm = ref_sketch.merge(ra, ref_sketch.update(ref0, jnp.asarray(hi[:99]),
                                                jnp.asarray(lo[:99])))
    np.testing.assert_array_equal(m.table.numpy(), np.asarray(rm.table))
    assert float(sketch.l2_estimate(m)) == float(ref_sketch.l2_estimate(rm))
    np.testing.assert_array_equal(
        heavy_hitters.exact_counts(thi, tlo, thi[:40], tlo[:40]).numpy(),
        np.asarray(ref_hh.exact_counts(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.asarray(hi[:40]),
                                       jnp.asarray(lo[:40]))))


# jitted: one compile per shape instead of one per primitive
_ref_sorted_runs = jax.jit(lambda hi, lo, m: ref_cand.sorted_runs(hi, lo,
                                                                  mask=m))
_ref_merge_runs = jax.jit(ref_cand.merge_runs, static_argnums=2)


def _to_ref_cands(c):
    return ref_cand.Candidates(
        key_hi=jnp.asarray(c.key_hi.numpy().astype(np.uint32)),
        key_lo=jnp.asarray(c.key_lo.numpy().astype(np.uint32)),
        count=jnp.asarray(c.count.numpy()), mask=jnp.asarray(c.mask.numpy()))


def _assert_cands_equal(c, ref):
    np.testing.assert_array_equal(c.key_hi.numpy(), np.asarray(ref.key_hi))
    np.testing.assert_array_equal(c.key_lo.numpy(), np.asarray(ref.key_lo))
    np.testing.assert_array_equal(c.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("universe,masked_tail,wide", [
    (None, False, True), (30, True, False), (400, True, True)])
def test_merge_runs_matches_reference(universe, masked_tail, wide):
    """A sequence of chunk merges into a 32-slot reservoir: the merged
    reservoir and the evicted max equal the reference's at every step,
    with and without a masked tail, and through overflow (universe 400
    and unbounded keys evict); runs_from_candidates and merge_topk too."""
    rng = np.random.default_rng(universe or 7)
    pool, ref_pool = candidates.empty(32), ref_cand.empty(32)
    evicted_any = False
    for step in range(4):
        n = 96
        if universe is None:
            hi, lo, thi, tlo = _keys(rng, n, bits=40 if wide else 32)
        else:
            u = rng.integers(0, universe, size=n).astype(np.uint64)
            u = u * np.uint64(0x9E3779B97F4A7C15 if wide else 1)
            hi = (u >> np.uint64(32)).astype(np.uint32)
            lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            thi, tlo = u64.from_numpy(hi), u64.from_numpy(lo)
        mask = np.ones(n, bool)
        if masked_tail:
            mask[n - 10 * (step + 1):] = False
        runs = candidates.sorted_runs(thi, tlo, mask=torch.from_numpy(mask))
        ref_runs = _ref_sorted_runs(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(mask))
        pool, ev = candidates.merge_runs(pool, runs, 32)
        ref_pool, ref_ev = _ref_merge_runs(ref_pool, ref_runs, 32)
        _assert_cands_equal(pool, ref_pool)
        assert float(ev) == float(ref_ev)
        evicted_any |= float(ev) > 0
    assert evicted_any == (universe is None or universe > 32)
    # the reservoir seen as runs, and merged back in through merge_runs
    rr = candidates.runs_from_candidates(pool)
    ref_rr = ref_cand.runs_from_candidates(ref_pool)
    for a, b in zip(rr, ref_rr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    half = candidates.Candidates(*[t[::2].clone() for t in pool])
    m, ev = candidates.merge_runs(half, rr, 32)
    rm, ref_ev = _ref_merge_runs(_to_ref_cands(half), ref_rr, 32)
    _assert_cands_equal(m, rm)
    assert float(ev) == float(ref_ev)
    t = pool.merge_topk(half, 20)
    _assert_cands_equal(t, ref_pool.merge_topk(_to_ref_cands(half), 20))
    assert pool.capacity == 32


def test_searchsorted_pair_matches_reference():
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 2 ** 40, size=50, dtype=np.uint64))
    keys[10:14] = keys[10]
    q = np.concatenate([keys[::3], rng.integers(0, 2 ** 40, size=20,
                                                dtype=np.uint64)])

    def limbs(k):
        return ((k >> np.uint64(32)).astype(np.uint32),
                (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    (bh, bl), (qh, ql) = limbs(keys), limbs(q)
    for side in ("left", "right"):
        got = candidates._searchsorted_pair(
            u64.from_numpy(bh), u64.from_numpy(bl), u64.from_numpy(qh),
            u64.from_numpy(ql), side)
        want = ref_cand._searchsorted_pair(*map(jnp.asarray, (bh, bl, qh, ql)),
                                           side)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_hash_params_are_checked():
    """The kernels read the six limb tensors through a pointer each:
    strided, non-int64 or misshapen limbs are refused."""
    from repro_torch.kernels.hash_points import check_params
    hp = carry.hash_params_from_numpy(*hash_params(0, 4))
    check_params("op", hp, torch.device("cpu"))
    for bad in (hp._replace(a1_hi=torch.zeros(8, dtype=torch.int64)[::2]),
                hp._replace(b_lo=hp.b_lo.int()),
                hp._replace(a2_lo=hp.a2_lo[:3])):
        with pytest.raises(ValueError, match="hash params"):
            check_params("op", bad, torch.device("cpu"))
