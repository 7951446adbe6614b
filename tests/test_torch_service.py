"""The online service (repro_torch.core.service) against the JAX
reference's ``repro.core.service`` on the CPU: one serving episode
(ingest → cold refresh → drift → warm refresh) in both packages on the
same points, the port given the reference's hash parameters and tSNE
init.  Bars: update stats and the refresh bookkeeping equal; the reps
bit for bit; the warm init and the embeddings within 1e-3 (the port's
whole-run tSNE bar after 10 iterations, tests/_torch_parity.py);
transform within 1e-3 of the reference's, identity queries on their
reps; checkpoints that load across the two packages both ways."""

import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import faults as ref_faults
from repro.core import pipeline as ref_pipeline
from repro.core import quantize as ref_quantize
from repro.core import resilience as ref_res
from repro.core import service as ref_service
from repro.core import stream as ref_stream
from repro.core.tsne import TsneConfig as RefTsneConfig
from repro_torch import carry
from repro_torch.core import faults, pipeline, quantize, resilience, service
from repro_torch.core import stream, tsne
from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture

SPEC = MixtureSpec(dims=3, n_clusters=4, cluster_std=0.05,
                   background_frac=0.0)
CFG = dict(bins=6, rows=8, log2_cols=10, top_k=32, candidate_pool=96,
           ingest_chunk=512, embedder="tsne", embed_backend="dense",
           max_replicas=4, seed=0)
TC = dict(dims=2, n_iter=10, exaggeration_iters=5, momentum_switch=5,
          perplexity=10.0, learning_rate=10.0)
SCFG = dict(transform_chunk=128, transform_k=4)
ATOL = 1e-3


def _spy_warm_init(svc, box):
    orig = svc._warm_init

    def spy(*args):
        out = orig(*args)
        box.append(out)
        return out
    svc._warm_init = spy


@pytest.fixture(scope="module")
def episode():
    pts, _ = gaussian_mixture(4000, SPEC, seed=1)
    drift, _ = gaussian_mixture(600, SPEC, seed=2)
    ref_grid = ref_quantize.fit_grid(np.concatenate([pts, drift]),
                                     CFG["bins"])
    grid = quantize.GridSpec(dims=3, bins=CFG["bins"], lo=ref_grid.lo,
                             hi=ref_grid.hi)
    ref = ref_service.SnsService(
        ref_pipeline.SnsConfig(**CFG), ref_grid,
        tsne_cfg=RefTsneConfig(**TC),
        service_cfg=ref_service.ServiceConfig(**SCFG))
    mine = service.SnsService(
        pipeline.SnsConfig(**CFG), grid, tsne_cfg=tsne.TsneConfig(**TC),
        service_cfg=service.ServiceConfig(**SCFG), device="cpu",
        hash_params=carry.hash_params_from_numpy(
            *par.hash_params(0, CFG["rows"])))
    out = {"ref": ref, "mine": mine, "pts": pts, "drift": drift,
           "grids": (ref_grid, grid), "warm_init": ([], [])}
    _spy_warm_init(ref, out["warm_init"][0])
    _spy_warm_init(mine, out["warm_init"][1])
    out["stats0"] = (ref.update([pts[:2000], pts[2000:]]),
                     mine.update([pts[:2000], pts[2000:]]))
    ref_cold = ref.refresh(mode="cold")
    n = ref_cold.embedding.shape[0]
    draws = carry.draws_from_numpy(tsne_init=par.tsne_init(0, n, 2))
    out["cold"] = (ref_cold, mine.refresh(mode="cold", draws=draws))
    out["cold_y"] = (np.asarray(ref_cold.embedding),
                     out["cold"][1].embedding.numpy().copy())
    out["stats1"] = (ref.update(drift), mine.update(drift))
    out["warm"] = (ref.refresh(), mine.refresh())
    return out


def test_update_stats_equal_the_reference(episode):
    for ref, mine in (episode["stats0"], episode["stats1"]):
        for k in ("points", "pending_fraction", "needs_refresh"):
            assert mine[k] == ref[k], k
        assert mine["points_per_sec"] > 0
    assert episode["stats0"][1]["pending_fraction"] == 1.0
    assert episode["stats1"][1]["needs_refresh"]
    assert stream.state_digest(episode["mine"].state) == \
        ref_stream.state_digest(episode["ref"].state)


def test_cold_then_warm_refresh_equal_the_reference(episode):
    (rc, mc), (rw, mw) = episode["cold"], episode["warm"]
    assert (mc.warm, mc.n_iters) == (rc.warm, rc.n_iters) == (False, 10)
    assert mw.warm and rw.warm
    for f in ("n_matched", "n_new", "n_iters"):
        assert getattr(mw, f) == getattr(rw, f), f
    assert mw.n_matched > mw.n_new > 0 and mw.n_iters == 1
    for r, m in ((rc, mc), (rw, mw)):
        np.testing.assert_array_equal(np.asarray(r.hh_ids), m.hh_ids.numpy())
        np.testing.assert_array_equal(np.asarray(r.weights),
                                      m.weights.numpy())
        assert m.kl_trace.shape == (m.n_iters,)
    ref_y0, mine_y0 = episode["warm_init"]
    (ry0, rm, rn), (my0, mm, mn) = ref_y0[-1], mine_y0[-1]
    assert (mm, mn) == (rm, rn)
    np.testing.assert_allclose(my0.numpy(), np.asarray(ry0), rtol=0,
                               atol=ATOL)
    cold_ref, cold_mine = episode["cold_y"]
    np.testing.assert_allclose(cold_mine, cold_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(mw.embedding.numpy(),
                               np.asarray(rw.embedding), rtol=0, atol=ATOL)
    ref_cache, cache = episode["ref"]._cache, episode["mine"]._cache
    np.testing.assert_array_equal(cache.rep_cell, ref_cache.rep_cell)
    np.testing.assert_array_equal(cache.rep_slot, ref_cache.rep_slot)
    np.testing.assert_array_equal(cache.rep_x.numpy(),
                                  np.asarray(ref_cache.rep_x))
    assert cache.min_hh_count == ref_cache.min_hh_count


def test_transform_equals_the_reference_in_chunks(episode, monkeypatch):
    ref, mine = episode["ref"], episode["mine"]
    q = np.concatenate([episode["drift"][:300],
                        np.random.default_rng(3).uniform(
                            -0.1, 1.1, (61, 3)).astype(np.float32)])
    rows = []
    orig = service.neighbors.knn_query

    def spy(qc, x, k, **kw):
        rows.append(qc.shape[0])
        return orig(qc, x, k, **kw)
    monkeypatch.setattr(service.neighbors, "knn_query", spy)
    got = mine.transform(q)
    assert rows == [128, 128, 105]       # never more than transform_chunk
    np.testing.assert_allclose(got.numpy(), ref.transform(q), rtol=0,
                               atol=ATOL)
    assert mine.transform(q[0]).shape == (2,)
    assert mine.transform(q[:0]).shape == (0, 2)
    cache = mine._cache
    ident = mine.transform(cache.rep_x)
    np.testing.assert_allclose(ident.numpy(), cache.rep_y.numpy(), rtol=0,
                               atol=1e-5)


def test_checkpoints_load_across_packages_both_ways(episode, tmp_path):
    ref, mine = episode["ref"], episode["mine"]
    q = episode["drift"][:200]
    ref_grid, grid = episode["grids"]
    mine.save(tmp_path / "mine")
    ref.save(tmp_path / "ref")
    theirs = ref_service.SnsService.load(
        tmp_path / "mine", ref_pipeline.SnsConfig(**CFG), ref_grid,
        tsne_cfg=RefTsneConfig(**TC),
        service_cfg=ref_service.ServiceConfig(**SCFG))
    back = service.SnsService.load(
        tmp_path / "ref", pipeline.SnsConfig(**CFG), grid,
        tsne_cfg=tsne.TsneConfig(**TC),
        service_cfg=service.ServiceConfig(**SCFG), device="cpu")
    for a, b in ((mine, theirs), (back, ref)):
        assert stream.state_digest(a.state) == \
            ref_stream.state_digest(b.state)
        for f in ("rep_cell", "rep_slot", "rep_x", "rep_y", "rep_w",
                  "rep_ids"):
            x, y = getattr(a._cache, f), np.asarray(getattr(b._cache, f))
            x = x.numpy() if isinstance(x, torch.Tensor) else x
            assert x.dtype == y.dtype or f == "rep_ids", f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a._cache.min_hh_count == b._cache.min_hh_count
        assert (a._pending, a._lost_mass, a._lost_shards,
                a._update_retries) == (b._pending, b._lost_mass,
                                       b._lost_shards, b._update_retries)
    # one snapshot, two placements: they differ only where the weights
    # of near neighbours take |q − x|² directly (the port) or from the
    # Gram identity (the reference)
    np.testing.assert_allclose(back.transform(q).numpy(), ref.transform(q),
                               rtol=0, atol=1e-4)
    # the port's own round trip serves the same bits; a corrupt newest
    # generation falls back to the .bak
    own = service.SnsService.load(
        tmp_path / "mine", pipeline.SnsConfig(**CFG), grid,
        tsne_cfg=tsne.TsneConfig(**TC),
        service_cfg=service.ServiceConfig(**SCFG), device="cpu")
    assert torch.equal(own.transform(q), mine.transform(q))
    own.update(q)
    own.save(tmp_path / "mine")
    faults.corrupt_file(stream._npz_path(tmp_path / "mine"), seed=1)
    old = service.SnsService.load(
        tmp_path / "mine", pipeline.SnsConfig(**CFG), grid,
        tsne_cfg=tsne.TsneConfig(**TC),
        service_cfg=service.ServiceConfig(**SCFG), device="cpu")
    assert stream.state_digest(old.state) == stream.state_digest(mine.state)
    assert torch.equal(old.transform(q), mine.transform(q))


def test_failed_refresh_rolls_back_and_health_equals_reference(
        episode, monkeypatch):
    ref, mine = episode["ref"], episode["mine"]
    hr, hm = ref.health(), mine.health()
    assert set(hm) == set(hr)
    for k in ("serving", "n_reps", "points", "pending_fraction",
              "needs_refresh", "hh_error_bound", "coverage", "lost_shards",
              "update_retries", "refreshes", "refresh_failures"):
        assert hm[k] == hr[k], k
    assert {k: v for k, v in hm["last_refresh"].items() if k != "seconds"} \
        == {k: v for k, v in hr["last_refresh"].items() if k != "seconds"}
    q = episode["drift"][:50]
    before, cache = mine.transform(q), mine._cache

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("injected out of memory")
    monkeypatch.setattr(pipeline, "embed_points", boom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        mine.refresh()
    assert mine._cache is cache and torch.equal(mine.transform(q), before)
    h = mine.health()
    assert h["refresh_failures"] == 1 and not h["last_refresh"]["ok"]
    assert "out of memory" in h["last_refresh"]["error"]
    monkeypatch.undo()
    mine._refresh_failures = 0


def test_not_ready_guards_and_config_validation():
    grid = quantize.GridSpec(dims=3, bins=6, lo=(0.0,) * 3, hi=(1.0,) * 3)
    svc = service.SnsService(pipeline.SnsConfig(**CFG), grid, device="cpu")
    with pytest.raises(service.ServiceNotReadyError, match="refresh"):
        svc.transform(np.zeros((2, 3), np.float32))
    with pytest.raises(service.ServiceNotReadyError, match="refresh"):
        svc.save("unused")
    with pytest.raises(ValueError, match="no previous embedding"):
        svc.refresh(mode="warm")
    with pytest.raises(ValueError, match="unknown refresh mode"):
        svc.refresh(mode="tepid")
    assert svc.needs_refresh() and svc.health()["serving"] is False
    for bad in (dict(refresh_drift=2.0), dict(error_ratio=-1.0),
                dict(warm_iters=-1), dict(warm_factor=0),
                dict(transform_k=0, transform_chunk=0),
                dict(transform_eps=0.0)):
        with pytest.raises(ValueError) as r:
            ref_service.ServiceConfig(**bad)
        with pytest.raises(ValueError) as m:
            service.ServiceConfig(**bad)
        assert str(m.value) == str(r.value)


def test_update_shards_equals_the_reference():
    """Per-shard ingest under chaos: the same coverage, lost shards,
    retries, folded state and per-shard attempt histograms."""
    pts, _ = gaussian_mixture(2400, SPEC, seed=4)
    shards = {s: (lambda p=pts[s * 400:(s + 1) * 400]: iter([p]))
              for s in range(6)}
    plan = dict(seed=5, drop_shards=(4,), flaky=0.4, corrupt=0.3)
    expected = {s: 400.0 for s in shards}
    g = ref_quantize.fit_grid(pts, CFG["bins"])
    cfg = dict(CFG, embedder="umap")
    ref = ref_service.SnsService(ref_pipeline.SnsConfig(**cfg), g)
    mine = service.SnsService(
        pipeline.SnsConfig(**cfg),
        quantize.GridSpec(dims=3, bins=CFG["bins"], lo=g.lo, hi=g.hi),
        device="cpu", hash_params=carry.hash_params_from_numpy(
            *par.hash_params(0, CFG["rows"])))
    kw = dict(expected_counts=expected)
    r = ref.update_shards(shards, faults=ref_faults.FaultPlan(**plan),
                          policy=ref_res.RetryPolicy(base_delay=0.001), **kw)
    m = mine.update_shards(shards, faults=faults.FaultPlan(**plan),
                           policy=resilience.RetryPolicy(base_delay=0.001),
                           **kw)
    for k in ("points", "coverage", "lost", "retries", "pending_fraction",
              "needs_refresh"):
        assert m[k] == r[k], k
    assert m["lost"] == [4] and m["retries"] >= 1
    assert stream.state_digest(mine.state) == \
        ref_stream.state_digest(ref.state)
    hr, hm = ref.health(), mine.health()
    for k in ("coverage", "hh_error_bound", "lost_shards", "update_retries"):
        assert hm[k] == hr[k], k
    for s, rec in hr["shard_latency"].items():
        assert (hm["shard_latency"][s]["attempts"],
                hm["shard_latency"][s]["failures"]) == (rec["attempts"],
                                                        rec["failures"])
        assert sum(hm["shard_latency"][s]["buckets"].values()) == \
            sum(rec["buckets"].values())
    with pytest.raises(resilience.CoverageError):
        mine.update_shards(shards, faults=faults.FaultPlan(drop=1.0),
                           policy=resilience.RetryPolicy(max_attempts=1))
    assert stream.state_digest(mine.state) == \
        ref_stream.state_digest(ref.state)
