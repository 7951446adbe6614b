"""Streaming ingest (``repro_torch.core.stream`` and the streaming
pipeline) against the JAX reference, on the CPU.

Both packages take the same hash parameters (the reference's draws,
carried as numpy).  Bars, the reference's own contract: the fold's table,
reservoir, count and eviction watermark bit for bit, through reservoir
overflow; streaming heavy hitters bit-identical to the one-shot's while
the reservoir is exact; checkpoints that each package resumes from the
other's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hash_params
from repro.core import heavy_hitters as ref_hh_mod
from repro.core import pipeline as ref_pipeline
from repro.core import quantize as ref_quantize
from repro.core import stream as ref_stream
from repro.data import loader as ref_loader
from repro_torch import carry
from repro_torch.core import heavy_hitters, pipeline, quantize, stream, umap
from repro_torch.data import loader

GRIDS = {  # 9 bits: keys in the low limb; 36 bits: the two-limb path
    "narrow": dict(dims=3, bins=8, lo=(0.0,) * 3, hi=(1.0,) * 3),
    "wide": dict(dims=6, bins=64, lo=(0.0,) * 6, hi=(1.0,) * 6)}
CFG = dict(bins=4, rows=8, log2_cols=10, top_k=32, candidate_pool=96,
           ingest_chunk=256, ingest_superbatch=3)


def _states(seed, rows, l2c, pool):
    hp = hash_params(seed, rows)
    return (ref_stream.init(jax.random.key(seed), rows, l2c, pool),
            stream.init(carry.hash_params_from_numpy(*hp), l2c, pool))


def _assert_state_equal(port, ref):
    leaves = jax.tree_util.tree_leaves(ref)
    mine = [port.sketch.table, *port.sketch.params, *port.cands, port.count,
            port.evict_max]
    assert len(leaves) == len(mine)
    for a, b in zip(mine, leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_hh_equal(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ragged(rng, n, d, sizes=(97, 300, 1, 0, 411)):
    pts = rng.uniform(-0.05, 1.05, size=(n, d)).astype(np.float32)
    cuts = np.cumsum(np.resize(sizes, n))
    cuts = cuts[cuts < n]
    return pts, np.split(pts, cuts)


@pytest.mark.parametrize("grid", ["narrow", "wide"])
def test_fold_matches_reference(grid):
    """One masked chunk, then a superbatched ingest_all over a
    ragged stream (a partial last superbatch padded with masked chunks),
    into a 24-slot reservoir that overflows: the state equals the
    reference's at each stage."""
    ref_grid = ref_quantize.GridSpec(**GRIDS[grid])
    g = quantize.GridSpec(**GRIDS[grid])
    rng = np.random.default_rng(3)
    ref_state, state = _states(5, 4, 9, 24)
    pts = rng.uniform(0, 1, size=(128, g.dims)).astype(np.float32)
    mask = np.arange(128) < 100
    ref_state = ref_stream.ingest_chunk(ref_state, jnp.asarray(pts),
                                        jnp.asarray(mask), grid=ref_grid)
    state = stream.ingest_chunk(state, torch.from_numpy(pts),
                                torch.from_numpy(mask), grid=g)
    _assert_state_equal(state, ref_state)
    _, chunks = _ragged(rng, 1500, g.dims)
    ref_state = ref_stream.ingest_all(ref_state, ref_grid, chunks, 128,
                                      superbatch=3)
    state = stream.ingest_all(state, g, chunks, 128, superbatch=3)
    _assert_state_equal(state, ref_state)
    assert float(state.count) == 1600.0
    assert float(stream.space_saving_bound(state)) > 0


def test_rechunk_and_streaming_grid_match_reference():
    rng = np.random.default_rng(4)
    pts, chunks = _ragged(rng, 1000, 3)
    for size in (128, 1000, 33):
        got = list(stream.rechunk(chunks, size))
        want = list(ref_stream.rechunk(chunks, size))
        assert len(got) == len(want)
        for (p, m), (rp, rm) in zip(got, want):
            np.testing.assert_array_equal(p, rp)
            np.testing.assert_array_equal(m, rm)
    g = quantize.fit_grid_streaming(lambda: iter(chunks), 25)
    assert g == quantize.fit_grid(torch.from_numpy(pts), 25)
    ref_g = ref_quantize.fit_grid_streaming(lambda: iter(chunks), 25)
    assert (g.lo, g.hi, g.bins) == (ref_g.lo, ref_g.hi, ref_g.bins)
    with pytest.raises(ValueError, match="empty chunk stream"):
        quantize.fit_grid_streaming([np.zeros((0, 3), np.float32)], 25)


def test_ingest_stream_errors_match_reference():
    pts = np.random.default_rng(5).uniform(size=(300, 3)).astype(np.float32)
    cfg = pipeline.SnsConfig(**CFG)
    ref_cfg = ref_pipeline.SnsConfig(**CFG)
    one_shot = iter([pts])
    exhausted = iter([pts])
    list(exhausted)
    grids = (quantize.GridSpec(**GRIDS["narrow"]),
             ref_quantize.GridSpec(**GRIDS["narrow"]))
    for source, grid, words in ((one_shot, (None, None), "one-shot iterator"),
                                (lambda: exhausted, grids, "saw no data")):
        with pytest.raises(ValueError, match=words) as mine:
            pipeline.sketch_stage_streaming(cfg, source, grid[0],
                                            device="cpu")
        with pytest.raises(ValueError, match=words) as ref:
            ref_pipeline.sketch_stage_streaming(ref_cfg, source, grid[1])
        assert str(mine.value) == str(ref.value)


def test_run_streaming_matches_reference_and_oneshot():
    """run_streaming's heavy hitters equal the reference's streaming
    sketch stage (the heavy hitters its run_streaming embeds) and the
    port's one-shot sketch stage while the reservoir is exact; run() and
    sketch_stage() take the same chunk factory."""
    from repro.data.synthetic import MixtureSpec, gaussian_mixture
    spec = MixtureSpec(dims=3, n_clusters=4, cluster_std=0.05,
                       background_frac=0.0)
    pts, _ = gaussian_mixture(2000, spec, seed=1)

    def factory():
        return (pts[s:s + 333] for s in range(0, len(pts), 333))
    cfg = pipeline.SnsConfig(**CFG)
    draws = carry.draws_from_numpy(hash_params=hash_params(cfg.seed,
                                                           cfg.rows))
    ucfg = umap.UmapConfig(n_neighbors=5, n_epochs=2)
    res = pipeline.run_streaming(cfg, factory, device="cpu", draws=draws,
                                 umap_cfg=ucfg)
    ref_grid, ref_hh, total = ref_pipeline.sketch_stage_streaming(
        ref_pipeline.SnsConfig(**CFG), factory)
    assert (res.grid.lo, res.grid.hi) == (ref_grid.lo, ref_grid.hi)
    assert total == 2000.0 and res.hh_error_bound == 0.0
    _assert_hh_equal(res.hh, ref_hh)
    grid, hh = pipeline.sketch_stage(cfg, pts, device="cpu",
                                     hash_params=draws.hash_params)
    assert grid == res.grid
    _assert_hh_equal(hh, ref_hh)
    assert res.coverage == pytest.approx(float(hh.count.sum()) / 2000)
    n = int(res.reps.mask.sum())
    assert res.embedding.shape == (n, 2) and n > 32
    g, h = pipeline.sketch_stage(cfg, factory, device="cpu",
                                 hash_params=draws.hash_params)
    _assert_hh_equal(h, ref_hh)


def test_streaming_heavy_hitters_match_reference_under_eviction():
    """A reservoir far smaller than the occupied cells (evict_max > 0):
    the port's streaming heavy hitters still equal the reference's
    streaming sketch stage on the same chunks and hash parameters, so a
    share below 1 against the one-shot is the algorithm's own."""
    from repro.data.synthetic import MixtureSpec, gaussian_mixture
    spec = MixtureSpec(dims=3, n_clusters=6, cluster_std=0.08,
                       background_frac=0.3)
    pts, _ = gaussian_mixture(4000, spec, seed=3)

    def factory():
        return (pts[s:s + 611] for s in range(0, len(pts), 611))
    kw = dict(CFG, bins=8, top_k=16, candidate_pool=40)
    cfg, ref_cfg = pipeline.SnsConfig(**kw), ref_pipeline.SnsConfig(**kw)
    hp = carry.hash_params_from_numpy(*hash_params(cfg.seed, cfg.rows))
    grid, state = pipeline._ingest_stream(cfg, factory, None,
                                          torch.device("cpu"), hp)
    ref_grid, ref_state = ref_pipeline._ingest_stream(ref_cfg, factory, None)
    assert int(state.evict_max) > 0
    _assert_state_equal(state, ref_state)
    g, hh, total = pipeline.sketch_stage_streaming(cfg, factory,
                                                   device="cpu",
                                                   hash_params=hp)
    rg, ref_hh, ref_total = ref_pipeline.sketch_stage_streaming(ref_cfg,
                                                                factory)
    assert (g.lo, g.hi) == (rg.lo, rg.hi) and total == ref_total == 4000.0
    _assert_hh_equal(hh, ref_hh)
    assert int(hh.mask.sum()) == 16


def test_checkpoint_round_trip_corruption_and_backup(tmp_path):
    rng = np.random.default_rng(6)
    g = quantize.GridSpec(**GRIDS["narrow"])
    _, state = _states(1, 4, 8, 16)
    state = stream.ingest_all(state, g, [rng.uniform(size=(500, 3))], 128)
    path = tmp_path / "ckpt"               # suffix-less on purpose
    stream.save_state(state, path, extra={"emb": np.arange(6.0)})
    back, extras = stream.load_state(path, with_extra=True, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(state)),
                    jax.tree_util.tree_leaves(tuple(back))):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(extras["emb"], np.arange(6.0))
    assert stream.state_digest(back) == stream.state_digest(state)
    # a second generation with a backup, then bit rot in the new file
    later = stream.ingest_all(stream.load_state(path, device="cpu"), g,
                              [rng.uniform(size=(100, 3))], 128)
    stream.save_state(later, path, keep_backup=True)
    target = str(path) + ".npz"
    raw = bytearray(open(target, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(target, "wb").write(bytes(raw))
    with pytest.raises(stream.CheckpointCorruptError):
        stream.load_state(path, device="cpu")
    old = stream.load_state(path, fallback=True, device="cpu")
    assert stream.state_digest(old) == stream.state_digest(state)
    assert stream.backup_path(path) == target + ".bak"


def test_checkpoints_cross_packages(tmp_path):
    """The reference saves mid-stream, the port loads and finishes: its
    heavy hitters equal the reference's whole-stream ones.  The port's
    checkpoint loads in the reference to the same arrays and digest, and
    merge_states and ingest_state_from_numpy agree with the reference."""
    rng = np.random.default_rng(7)
    g = quantize.GridSpec(**GRIDS["wide"])
    ref_grid = ref_quantize.GridSpec(**GRIDS["wide"])
    chunks = [rng.uniform(size=(256, 6)).astype(np.float32)
              for _ in range(6)]
    ref_whole, mine = _states(2, 4, 10, 48)
    ref_whole = ref_stream.ingest_all(ref_whole, ref_grid, chunks, 256,
                                      superbatch=2)
    ref_half, _ = _states(2, 4, 10, 48)
    ref_half = ref_stream.ingest_all(ref_half, ref_grid, chunks[:2], 256,
                                     superbatch=2)
    ref_stream.save_state(ref_half, tmp_path / "ref")
    resumed = stream.ingest_all(
        stream.load_state(tmp_path / "ref", device="cpu"), g, chunks[2:],
        256, superbatch=2)
    _assert_state_equal(resumed, ref_whole)
    _assert_hh_equal(
        heavy_hitters.from_candidates(resumed.sketch, resumed.cands, 20),
        ref_hh_mod.from_candidates(ref_whole.sketch, ref_whole.cands, 20))

    mine = stream.ingest_all(mine, g, chunks[:3], 256, superbatch=2)
    stream.save_state(mine, tmp_path / "port", extra={"x": np.ones(3)})
    theirs, extras = ref_stream.load_state(tmp_path / "port",
                                           with_extra=True)
    _assert_state_equal(mine, theirs)
    assert stream.state_digest(mine) == ref_stream.state_digest(theirs)
    np.testing.assert_array_equal(extras["x"], np.ones(3))

    carried = carry.ingest_state_from_numpy(ref_half)
    _assert_state_equal(carried, ref_half)
    merged = stream.merge_states(mine, carried)
    _assert_state_equal(merged, ref_stream.merge_states(theirs, ref_half))
    with pytest.raises(ValueError, match="geometry"):
        stream.merge_states(mine, _states(0, 4, 9, 48)[1])


def test_loader_copy_matches_reference():
    for plan_args in ((16, 3, 0), (16, 3, 2), (7, 2, 1)):
        plan, ref_plan = (loader.ShardPlan(*plan_args),
                          ref_loader.ShardPlan(*plan_args))
        for h in range(plan.num_hosts):
            assert plan.shards_for(h) == ref_plan.shards_for(h)
            assert plan.steal_order(h) == ref_plan.steal_order(h)

    def make_batch(shard, b):
        if shard == 5:
            raise IOError("shard 5 is gone")
        return np.full((3, 2), shard * 10 + b, np.float32)

    def skip(shard, exc):
        return True
    runs = []
    for mod in (loader, ref_loader):
        ld = mod.ShardedLoader(mod.ShardPlan(12, 3), 1, make_batch,
                               batches_per_shard=2, on_error=skip)
        runs.append(([(s, b.tolist()) for s, b in ld],
                     [(s, b.tolist()) for s, b in ld.steal([0, 3])],
                     ld.completed, ld.failed))
    assert runs[0] == runs[1]

    done = []
    factory = pipeline.chunks_from_loader(
        loader.ShardPlan(8, 2), 0, make_batch, steal=True,
        globally_completed=[1], on_shard_done=done.append,
        on_shard_error=skip)
    got = [int(b[0, 0]) // 10 for b in factory()]
    ref_done = []
    ref_factory = ref_pipeline.chunks_from_loader(
        ref_loader.ShardPlan(8, 2), 0, make_batch, steal=True,
        globally_completed=[1], on_shard_done=ref_done.append,
        on_shard_error=skip)
    assert got == [int(b[0, 0]) // 10 for b in ref_factory()]
    assert done == ref_done
    # faults= wraps make_batch with the reference's chaos: the same
    # batches skipped, bit-flipped and delivered
    from repro.core.faults import FaultPlan as RefPlan
    from repro_torch.core.faults import FaultPlan
    chaos = dict(seed=3, drop_shards=(2,), corrupt=0.4)
    runs = []
    for mod, plan, p in ((pipeline, FaultPlan(**chaos), loader),
                         (ref_pipeline, RefPlan(**chaos), ref_loader)):
        failed = []
        fac = mod.chunks_from_loader(
            p.ShardPlan(8, 2), 0, make_batch, batches_per_shard=2,
            faults=plan,
            on_shard_error=lambda s, e: failed.append(s) or True)
        runs.append(([b.tobytes() for b in fac()], failed))
    assert runs[0] == runs[1] and runs[0][1] == [2]
    cfg = dataclasses.replace(pipeline.SnsConfig(**CFG), ingest_chunk=4)
    grid, hh, total = pipeline.sketch_stage_streaming(
        cfg, pipeline.chunks_from_loader(loader.ShardPlan(4, 1), 0,
                                         lambda s, b: np.random.default_rng(
                                             s).uniform(size=(9, 2))),
        device="cpu")
    assert total == 36.0 and int(hh.mask.sum()) > 0
