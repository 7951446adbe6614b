"""Geo-distributed sketching (repro_torch.core.geo) against the JAX
reference's ``repro.core.geo`` on the CPU.  The host tier: per-site fold
jobs under a fault plan, collected, merged and extracted, give the
reference's heavy hitters bit for bit and its damage report.  The SPMD
tier on one in-process rank; tests/test_torch_mesh.py runs it on four."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hash_params
from repro.core import geo as ref_geo
from repro.core import heavy_hitters as ref_hh
from repro.core import quantize as ref_quantize
from repro.core import sketch as ref_sketch
from repro.core.faults import FaultPlan as RefPlan
from repro.core.resilience import RetryPolicy as RefPolicy
from repro_torch import carry
from repro_torch.core import faults, geo, quantize, resilience, sketch
from repro_torch.core import mesh as mesh_mod
from repro_torch.data.synthetic import (MixtureSpec, clustered_points_sharded,
                                        gaussian_mixture)

N_SHARDS, PER_SHARD = 5, 400
KW = dict(rows=4, log2_cols=10, top_k=24, candidate_pool=160, seed=0,
          chunk_size=128, superbatch=2)
FAST = dict(max_attempts=4, base_delay=0.001, max_delay=0.01)


@pytest.fixture(scope="module")
def case():
    spec = MixtureSpec(dims=3, n_clusters=3, cluster_std=0.05,
                       background_frac=0.1)
    data = {s: clustered_points_sharded(s, PER_SHARD, spec, seed=2)
            for s in range(N_SHARDS)}
    g = ref_quantize.fit_grid(np.concatenate(list(data.values())), 6)
    return data, g, quantize.GridSpec(dims=3, bins=6, lo=g.lo, hi=g.hi)


def _sources(data):
    """Each shard as a factory of its chunks (re-read on a retry)."""
    return {s: (lambda p=p: iter([p[:150], p[150:]])) for s, p in data.items()}


@pytest.mark.parametrize("plan", [
    dict(seed=4, drop_shards=(2,), flaky=0.4, duplicate=0.3, corrupt=0.3),
    dict(seed=1, drop=0.3, flaky=0.3, corrupt=0.6),
])
def test_resilient_extract_equals_the_reference(case, plan):
    data, ref_grid, grid = case
    expected = {s: float(PER_SHARD) for s in data}
    ref = ref_geo.resilient_extract(
        ref_grid, _sources(data), policy=RefPolicy(**FAST),
        faults=RefPlan(**plan), expected_counts=expected, **KW)
    got = geo.resilient_extract(
        grid, _sources(data), policy=resilience.RetryPolicy(**FAST),
        faults=faults.FaultPlan(**plan), expected_counts=expected,
        device="cpu",
        hash_params=carry.hash_params_from_numpy(*hash_params(0, 4)), **KW)
    for a, b in zip(got.hh, ref.hh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.merged.table.numpy(),
                                  np.asarray(ref.merged.table))
    for f in ("observed_count", "coverage", "hh_error_bound", "lost",
              "retries"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.lost and got.retries >= 1 and got.coverage < 1.0
    assert [s.attempts for s in got.statuses] == \
        [s.attempts for s in ref.statuses]


def test_resilient_extract_guards(case):
    _, _, grid = case
    with pytest.raises(ValueError, match="at least one shard"):
        geo.resilient_extract(grid, {}, device="cpu", **KW)


@pytest.mark.parametrize("fn", [geo.sketch_shard, geo.geo_extract,
                                geo.geo_extract_from_shards])
def test_mesh_functions_raise_p12(fn, tmp_path):
    """The SPMD tier, once three ROADMAP P12 stubs that raised, runs:
    one rank in this process on a (1, 1) ("pod", "data") mesh against the
    reference bit for bit, with no hash parameters fed to either:
    ``sketch_shard`` outside any mesh, ``geo_extract_from_shards`` on a
    (1, 1) XLA mesh, and ``geo_extract`` against what the reference's
    computes on one device (its shard's fold and candidates, the top-k
    on them; a size-1 psum and all_gather are the identity), as its
    shard_map takes ~25 s to compile here.  tests/test_torch_mesh.py
    holds ``geo_extract`` on four ranks to the reference's own."""
    pts, _ = gaussian_mixture(2000, MixtureSpec(dims=4), seed=5)
    g = ref_quantize.fit_grid(jnp.asarray(pts), 16)
    grid = quantize.GridSpec(dims=4, bins=16, lo=g.lo, hi=g.hi)
    fields = ("key_hi", "key_lo", "count", "mask")
    if fn is geo.sketch_shard:
        rsk, rc, rd = ref_geo.sketch_shard(
            ref_sketch.init(jax.random.key(0), 8, 12), g, jnp.asarray(pts),
            64)
        sk, c, d = geo.sketch_shard(
            sketch.init(geo.shared_params(0, 8, "cpu"), 12), grid,
            torch.from_numpy(pts), 64)
        np.testing.assert_array_equal(sk.table.numpy(), np.asarray(rsk.table))
        for f in fields:
            np.testing.assert_array_equal(
                getattr(c, f).numpy().astype(np.float64),
                np.asarray(getattr(rc, f)).astype(np.float64), err_msg=f)
        assert float(d) == float(rd)
        return
    rmesh = jax.make_mesh((1, 1), ("pod", "data"))
    mesh = mesh_mod.init_mesh(0, 1, f"file://{tmp_path / 'rendezvous'}",
                              (1, 1), ("pod", "data"), backend="gloo")
    kw = dict(rows=8, log2_cols=12, top_k=64, data_axes=("data", "pod"),
              seed=0)
    try:
        if fn is geo.geo_extract:
            sk, cands, dropped = ref_geo.sketch_shard(
                ref_sketch.init(jax.random.key(0), 8, 12), g,
                jnp.asarray(pts), 128)
            want = ref_geo.GeoSketchResult(
                hh=ref_hh.from_candidates(sk, cands, 64), merged=sk,
                total_count=len(pts), evict_max=dropped)
            got = geo.geo_extract(mesh, grid, pts, device="cpu", **kw)
        else:
            jp = jnp.asarray(pts)
            want = ref_geo.geo_extract_from_shards(
                rmesh, g, lambda i, b: (jax.lax.dynamic_slice_in_dim(
                    jp, b * 500, 500), None), num_batches=4, **kw)
            got = geo.geo_extract_from_shards(
                mesh, grid, lambda i, b: (pts[b * 500:(b + 1) * 500], None),
                num_batches=4, device="cpu", **kw)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(got.merged.table.numpy(),
                                  np.asarray(want.merged.table))
    for f in fields:
        np.testing.assert_array_equal(
            getattr(got.hh, f).numpy().astype(np.float64),
            np.asarray(getattr(want.hh, f)).astype(np.float64), err_msg=f)
    assert float(got.total_count) == float(want.total_count) == 2000.0
    assert float(got.evict_max) == float(want.evict_max)
