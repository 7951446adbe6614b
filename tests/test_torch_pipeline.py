"""The port's first slice end to end (repro_torch.core.pipeline.run) against
the JAX reference at a tiny size, with every random draw carried across:
the same heavy hitters and representatives, bit for bit, and an
embedding within 1e-4.

The embedding bar holds at one replica per cell.  With several jittered
replicas a fraction of a cell apart, the fp32 Gram-identity distances
(summed in different orders by XLA and by torch) differ in their last
bits relative to tiny pair distances, the fuzzy set turns that into
~1e-4 membership differences, and three SGD epochs amplify them; the
module-level bars for that path are in test_torch_umap.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import pipeline as ref_pipeline
from repro.core import umap as ref_umap
from repro.data.synthetic import MixtureSpec as RefSpec
from repro.data.synthetic import gaussian_mixture as ref_mixture
from repro_torch import carry
from repro_torch.configs import sns_paper
from repro_torch.core import pipeline, tsne, umap
from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture


def _port_cfg(ref_cfg, **kw):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg) if f.name != "kernel_mode"}
    fields.update(kw)
    return pipeline.SnsConfig(**fields)


@pytest.mark.parametrize("max_replicas", [1, 8])
def test_run_matches_reference_given_draws(max_replicas):
    pts, _ = gaussian_mixture(4000, MixtureSpec(dims=4), seed=3)
    ref_cfg = ref_pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=64,
                                     max_replicas=max_replicas)
    ucfg = dict(n_neighbors=5, n_epochs=3)
    ref = ref_pipeline.run(ref_cfg, jnp.asarray(pts),
                           umap_cfg=ref_umap.UmapConfig(**ucfg))
    n = ref.embedding.shape[0]
    init, negs = par.umap_draws(par.embed_key(ref_cfg.seed), n, n * 5, 2,
                                3, 5)
    draws = carry.draws_from_numpy(
        hash_params=par.hash_params(ref_cfg.seed, ref_cfg.rows),
        jitter=par.replica_jitter(ref_cfg.seed, ref.hh.key_hi, ref.hh.key_lo,
                                  max_replicas, 4, ref_cfg.jitter_frac),
        umap_init=init, negatives=negs)
    got = pipeline.run(_port_cfg(ref_cfg), pts, device="cpu", draws=draws,
                       umap_cfg=umap.UmapConfig(**ucfg))
    for f in ref.hh._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.hh, f)).astype(np.float64),
            getattr(got.hh, f).numpy().astype(np.float64), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.reps.mask),
                                  got.reps.mask.numpy())
    np.testing.assert_array_equal(ref.rep_weight, got.rep_weight.numpy())
    np.testing.assert_array_equal(ref.rep_hh_id, got.rep_hh_id.numpy())
    rp = np.asarray(ref.reps.points)
    assert np.all(np.abs(rp - got.reps.points.numpy()) <= np.spacing(
        np.abs(rp)))
    assert (got.coverage, got.hh_error_bound) == (ref.coverage,
                                                  ref.hh_error_bound)
    assert set(got.stage_seconds) == {
        "sketch", "sketch.grid", "sketch.keys", "sketch.sort",
        "sketch.update", "sketch.candidates", "sketch.estimate", "replicas",
        "embed", "embed.knn", "embed.affinity", "embed.layout",
        "embed.optimize"}
    emb = got.embedding.numpy()
    assert emb.shape == ref.embedding.shape and np.isfinite(emb).all()
    if max_replicas == 1:
        np.testing.assert_allclose(emb, np.asarray(ref.embedding), rtol=0,
                                   atol=1e-4)


def test_synthetic_data_and_paper_configs_match_reference():
    spec = dict(dims=5, n_clusters=4, background_frac=0.2)
    p, lab = gaussian_mixture(3001, MixtureSpec(**spec), seed=7)
    rp, rlab = ref_mixture(3001, RefSpec(**spec), seed=7)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(lab, rlab)
    from repro.configs import sns_paper as ref_paper
    for name in ("CANCER", "SDSS", "CANCER_ERROR_EVAL", "CANCER_100K",
                 "SDSS_100K", "CANCER_1M"):
        ref = dataclasses.asdict(getattr(ref_paper, name))
        assert ref.pop("kernel_mode") == "auto"
        assert dataclasses.asdict(getattr(sns_paper, name)) == ref


BAD = [dict(bins=1), dict(rows=0), dict(log2_cols=0), dict(log2_cols=32),
       dict(top_k=0), dict(candidate_pool=-1), dict(ingest_chunk=0),
       dict(ingest_superbatch=0), dict(replica_scheme="zipf"),
       dict(max_replicas=0), dict(jitter_frac=1.5), dict(embedder="pca"),
       dict(embed_dims=0), dict(embed_backend="fast"), dict(embed_block=0),
       dict(embed_knn=-1), dict(embed_grid=1), dict(embed_grid_interval=-1.0),
       dict(embed_grid=256, embed_grid_max=128), dict(embed_cic="cuda"),
       dict(embed_knn_method="hnsw")]


@pytest.mark.parametrize("bad", BAD)
def test_config_fails_loud_like_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_pipeline.SnsConfig(**bad)
    with pytest.raises(ValueError) as err:
        pipeline.SnsConfig(**bad)
    assert str(err.value) == str(ref_err.value)


def test_config_has_the_reference_fields_less_kernel_mode():
    """The port's kernels are chosen by the tensors' device, so the
    reference's kernel-tier knob has no counterpart."""
    ref = [f.name for f in dataclasses.fields(ref_pipeline.SnsConfig)]
    assert [f.name for f in dataclasses.fields(pipeline.SnsConfig)] == [
        n for n in ref if n != "kernel_mode"]
    assert "kernel_mode" not in {
        f.name for f in dataclasses.fields(umap.UmapConfig)}
    with pytest.raises(TypeError):
        pipeline.SnsConfig(kernel_mode="auto")


def test_unported_paths_raise_with_their_roadmap_item():
    """The embed mesh needs a process group under both embedders (the
    tSNE one, P12b, once raising here, now runs); the ported mesh paths
    (P12) refuse what the reference refuses (a chunk iterator with a
    mesh, mesh streaming without shard_fn or grid) and what is no mesh,
    without a process group; chunk-iterator input (P11, streaming ingest) runs
    through run and sketch_stage to the one-shot's heavy hitters; the
    approximate kNN (P9) runs under both embedders."""
    pts, _ = gaussian_mixture(500, MixtureSpec(dims=3), seed=1)
    # a pool of all 4**3 cells: the streaming reservoir stays exact
    cfg = pipeline.SnsConfig(bins=4, rows=2, log2_cols=6, top_k=8,
                             candidate_pool=64, ingest_chunk=64,
                             ingest_superbatch=2)
    small = dict(umap_cfg=umap.UmapConfig(n_neighbors=3, n_epochs=1))
    cases = [
        (dataclasses.replace(cfg, embedder="tsne", embed_mesh=2), pts, {},
         ValueError, "torch.distributed initialized"),
        (dataclasses.replace(cfg, embed_mesh=2), pts, small, ValueError,
         "torch.distributed initialized"),
        (cfg, pts, {"mesh": 2}, TypeError, "DeviceMesh"),
        (cfg, [pts], {"mesh": 2}, ValueError, "single-host only"),
    ]
    for c, p, kw, exc, msg in cases:
        with pytest.raises(exc, match=msg):
            pipeline.run(c, p, device="cpu", **kw)
    with pytest.raises(ValueError, match="needs shard_fn"):
        pipeline.run_streaming(cfg, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="agreed grid"):
        pipeline.run_streaming(cfg, mesh=2, shard_fn=lambda i, b: b,
                               device="cpu")
    grid, hh = pipeline.sketch_stage(cfg, pts, device="cpu")
    for source in ([pts[:300], pts[300:]],
                   lambda: iter([pts[:123], pts[123:]])):
        g, h = pipeline.sketch_stage(cfg, source, device="cpu")
        assert g == grid
        for a, b in zip(h, hh):
            assert torch.equal(a, b)
        res = pipeline.run(cfg, source, device="cpu", **small)
        assert res.grid == grid and torch.equal(res.hh.key_lo, hh.key_lo)
        assert set(res.stage_seconds) == {
            "grid", "ingest", "extract", "replicas", "embed", "embed.knn",
            "embed.affinity", "embed.layout", "embed.optimize"}
        n = int(res.reps.mask.sum())
        assert res.embedding.shape == (n, 2)
    for c, kw in [
            (dataclasses.replace(cfg, embedder="tsne", embed_backend="sparse",
                                 embed_knn_method="ann", embed_grid=16),
             dict(tsne_cfg=tsne.TsneConfig(n_iter=5, perplexity=2.0))),
            (dataclasses.replace(cfg, embed_knn_method="ann"), small)]:
        res = pipeline.run(c, pts, device="cpu", **kw)
        n = int(res.reps.mask.sum())
        assert n > 3 and res.embedding.shape == (n, 2)
        assert {"embed.knn.probes", "embed.knn.descent"} <= set(
            res.stage_seconds)
        assert bool(torch.isfinite(res.embedding).all())


def test_entry_points_default_to_the_card():
    """device=None means CUDA; without a card the run stops, it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    pts, _ = gaussian_mixture(200, MixtureSpec(dims=3), seed=1)
    cfg = pipeline.SnsConfig(bins=4, rows=2, log2_cols=6, top_k=8)
    from repro_torch.core import quantize, service
    grid = quantize.GridSpec(dims=3, bins=4, lo=(0.0,) * 3, hi=(1.0,) * 3)
    _, hh = pipeline.sketch_stage(cfg, pts, grid, device="cpu")
    for call in (lambda: pipeline.run(cfg, pts),
                 lambda: pipeline.sketch_stage(cfg, pts),
                 lambda: pipeline.run_resilient(cfg, [pts], grid),
                 lambda: pipeline.assign_points_to_hh(grid, hh, pts),
                 lambda: service.SnsService(cfg, grid)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sharded_data_and_collision_model_match_reference():
    from repro.core import quantize as ref_quantize
    from repro.data.synthetic import clustered_points_sharded as ref_sharded
    from repro_torch.core import quantize
    from repro_torch.data.synthetic import clustered_points_sharded
    spec = dict(dims=4, n_clusters=3)
    for shard, seed in [(0, 0), (3, 2)]:
        np.testing.assert_array_equal(
            clustered_points_sharded(shard, 777, MixtureSpec(**spec), seed),
            ref_sharded(shard, 777, RefSpec(**spec), seed))
    for args in [(8.0 ** 10, 10_000, 10), (16.0 ** 10, 10_000, 10),
                 (25.0 ** 8, 20_000, 8), (1e3, 5, 2)]:
        assert quantize.collision_rate(*args) == \
            ref_quantize.collision_rate(*args)
        assert quantize.collision_rate_text(*args) == \
            ref_quantize.collision_rate_text(*args)
    # the paper's published numbers (§III-2)
    assert quantize.collision_rate(8.0 ** 10, 10_000, 10)[1] == \
        pytest.approx(1057, rel=1e-3)


def test_assign_points_to_hh_matches_reference_bit_for_bit():
    """Labels equal the reference's on mixture points, points on the
    grid's corners and cell edges, points outside it, and every chunk
    size (a ragged last chunk included)."""
    from repro_torch.core import quantize
    from repro_torch.core.heavy_hitters import HeavyHitters
    pts, _ = gaussian_mixture(3000, MixtureSpec(dims=3, n_clusters=3),
                              seed=5)
    ref_cfg = ref_pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=40)
    ref_grid, ref_hh = ref_pipeline.sketch_stage(ref_cfg, jnp.asarray(pts))
    grid = quantize.GridSpec(dims=3, bins=8, lo=ref_grid.lo, hi=ref_grid.hi)
    lo, hi = np.asarray(ref_grid.lo, np.float32), np.asarray(ref_grid.hi,
                                                             np.float32)
    cell = (hi - lo) / 8
    edges = lo + cell * np.arange(9, dtype=np.float32)[:, None]
    rng = np.random.default_rng(0)
    extra = np.concatenate([
        np.stack([lo, hi, lo - 1.0, hi + 1.0]),
        edges[rng.integers(0, 9, size=(300, 3)), np.arange(3)],
        np.nextafter(edges, np.inf)[rng.integers(0, 9, size=(100, 3)),
                                    np.arange(3)]]).astype(np.float32)
    q = np.concatenate([pts, extra])
    thh = HeavyHitters(*[torch.from_numpy(np.asarray(a).astype(
        np.int64 if a.dtype == jnp.uint32 else a.dtype)) for a in ref_hh])
    for chunk in (65536, 1000, 7):
        want = ref_pipeline.assign_points_to_hh(ref_grid, ref_hh,
                                                jnp.asarray(q), chunk)
        got = pipeline.assign_points_to_hh(grid, thh, q, chunk,
                                           device="cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want >= 0).mean() < 1
    none = thh._replace(mask=torch.zeros_like(thh.mask))
    assert bool((pipeline.assign_points_to_hh(grid, none, q, device="cpu")
                 == -1).all())


def test_run_resilient_matches_reference_given_draws():
    """A dead shard, flaky and corrupt deliveries: the heavy hitters and
    reps equal the reference's bit for bit, the damage report equals its,
    and with one replica a cell and the reference's UMAP draws the
    embedding is within 1e-4."""
    from repro.core import faults as ref_faults
    from repro.core import quantize as ref_quantize
    from repro.core import resilience as ref_res
    from repro_torch.core import faults, quantize, resilience
    from repro_torch.data.synthetic import clustered_points_sharded
    spec = MixtureSpec(dims=3, n_clusters=3, cluster_std=0.05)
    data = {s: clustered_points_sharded(s, 500, spec, seed=1)
            for s in range(4)}
    kw = dict(bins=6, rows=4, log2_cols=10, top_k=32, candidate_pool=128,
              ingest_chunk=128, ingest_superbatch=2, max_replicas=1)
    plan = dict(seed=2, drop_shards=(1,), flaky=0.4, corrupt=0.4)
    expected = {s: 500.0 for s in data}
    ucfg = dict(n_neighbors=5, n_epochs=3)
    ref_cfg = ref_pipeline.SnsConfig(**kw)
    ref_grid = ref_quantize.fit_grid(np.concatenate(list(data.values())), 6)
    ref = ref_pipeline.run_resilient(
        ref_cfg, data, ref_grid, faults=ref_faults.FaultPlan(**plan),
        policy=ref_res.RetryPolicy(max_attempts=4, base_delay=0.001),
        expected_counts=expected, umap_cfg=ref_umap.UmapConfig(**ucfg))
    n = ref.embedding.shape[0]
    init, negs = par.umap_draws(par.embed_key(0), n, n * 5, 2, 3, 5)
    draws = carry.draws_from_numpy(hash_params=par.hash_params(0, 4),
                                   umap_init=init, negatives=negs)
    grid = quantize.GridSpec(dims=3, bins=6, lo=ref_grid.lo, hi=ref_grid.hi)
    got = pipeline.run_resilient(
        pipeline.SnsConfig(**kw), data, grid,
        faults=faults.FaultPlan(**plan),
        policy=resilience.RetryPolicy(max_attempts=4, base_delay=0.001),
        expected_counts=expected, umap_cfg=umap.UmapConfig(**ucfg),
        device="cpu", draws=draws)
    for f in ref.hh._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.hh, f)).astype(np.float64),
            getattr(got.hh, f).numpy().astype(np.float64), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.reps.points),
                                  got.reps.points.numpy())
    for f in ("coverage", "hh_error_bound", "ingest_coverage",
              "lost_shards"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.lost_shards == (1,) and got.ingest_coverage == 0.75
    assert set(got.stage_seconds) == {
        "ingest", "replicas", "embed", "embed.knn", "embed.affinity",
        "embed.layout", "embed.optimize"}
    np.testing.assert_allclose(got.embedding.numpy(),
                               np.asarray(ref.embedding), rtol=0, atol=1e-4)
