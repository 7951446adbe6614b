"""The port's mesh tier (repro_torch.core.mesh, geo's SPMD tier, the
sharded kNN and UMAP) against the JAX reference on the CPU.

Four gloo CPU ranks (tests/_torch_mesh_ranks.py) run as a (2, 2)
("pod", "data") mesh, sharded over ``("data", "pod")``; the reference's
``geo_extract`` runs on a 4-device XLA mesh in a subprocess (the device
count must be set before jax starts, as tests/test_geo.py does).  Both
start once, together, for the whole module.

Bars, as the reference pins them: merged tables on integer counts and
heavy hitters bit for bit; ``knn_graph(mesh=)`` bit for bit; the sharded
UMAP within 1e-4·scale after one epoch and 2e-2·scale after three
(tests/test_mesh_embed.py:307), and the pipeline with ``embed_mesh``
within 1e-3·scale (:466).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks_mod
import _torch_parity as par
from repro.core import hashing as ref_hashing
from repro.core import neighbors as ref_neighbors
from repro.core import pipeline as ref_pipeline
from repro.core import quantize as ref_quantize
from repro.core import sketch as ref_sketch
from repro.core import umap as ref_umap
from repro_torch.core import coo, geo, neighbors, pipeline, prng, replicas
from repro_torch.core import umap
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import quantize, sketch, u64

ROOT = Path(__file__).resolve().parents[1]
GEO = dict(rows=8, log2_cols=12, top_k=64)
HH_FIELDS = ("key_hi", "key_lo", "count", "mask")

_REF4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from repro.core import geo, quantize
    inp = np.load(sys.argv[1])
    grid = quantize.GridSpec(dims=4, bins=16, lo=inp["geo_lo"],
                             hi=inp["geo_hi"])
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    res = geo.geo_extract(mesh, grid, jax.numpy.asarray(inp["geo_pts"]),
                          rows=8, log2_cols=12, top_k=64,
                          data_axes=("data", "pod"), seed=0)
    out = {f"hh_{f}": np.asarray(getattr(res.hh, f)) for f in res.hh._fields}
    np.savez(sys.argv[2], table=np.asarray(res.merged.table),
             total=np.asarray(res.total_count),
             evict=np.asarray(res.evict_max), **out)
""")


def _geo_points(n=8000):
    """tests/test_geo.py's clustered data at a smaller n."""
    rng = np.random.default_rng(0)
    centers = np.asarray([[0.2] * 4, [0.8] * 4, [0.2, 0.8, 0.2, 0.8]])
    pts = [rng.uniform(0, 1, size=(n // 4, 4))]
    for c in centers:
        pts.append(c + 0.02 * rng.normal(size=(n // 4, 4)))
    pts = np.clip(np.concatenate(pts), 0, 1).astype(np.float32)
    rng.shuffle(pts)
    return pts


def _blob_data(n=203, dims=5, seed=0):
    """tests/test_mesh_embed.py's two weighted blobs at a non-dividing N."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, dims)),
                        rng.normal(6, 1, (n - n // 2, dims))])
    w = rng.integers(1, 50, n).astype(np.float32)
    return x.astype(np.float32), w


PIPE = dict(bins=8, rows=4, log2_cols=10, top_k=64)   # test_mesh_embed:466
PIPE_UMAP = dict(n_epochs=2, n_neighbors=8)
BLOB_UMAP = dict(n_neighbors=10, block=64)


def _pipe_points():
    return np.random.default_rng(4).uniform(0, 1, size=(4096, 3)).astype(
        np.float32)


def _inputs():
    """Every input of the ranks.  The UMAP draws are the reference's; the
    pipeline's representative count comes from the port's own sketch and
    replicas, which are the reference's bit for bit."""
    pts = _geo_points()
    g = ref_quantize.fit_grid(jnp.asarray(pts), 16)
    x, w = _blob_data()
    u_init, u_negs = par.umap_draws(jax.random.key(7), len(x), len(x) * 10,
                                    2, 3, 5)
    ppts = _pipe_points()
    cfg = pipeline.SnsConfig(**PIPE)
    grid, hh = pipeline.sketch_stage(cfg, ppts, device="cpu")
    n = int(replicas.make_representatives(
        grid, hh, scheme=cfg.replica_scheme, max_replicas=cfg.max_replicas,
        key=prng.key(0)).mask.sum())
    p_init, p_negs = par.umap_draws(par.embed_key(cfg.seed), n,
                                    n * min(8, n - 1), 2, 2, 5)
    return dict(geo_pts=pts, geo_lo=np.asarray(g.lo, np.float32),
                geo_hi=np.asarray(g.hi, np.float32), blob_x=x, blob_w=w,
                umap_init=u_init, umap_negs=u_negs, pipe_pts=ppts,
                pipe_init=p_init, pipe_negs=p_negs)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the in-process references, the four ranks' outputs, the
    reference's 4-device geo_extract).  The ranks and the reference's
    subprocess start first and run while this process computes its
    references: the single-device fold, the single-device UMAP runs and
    the single-device ``pipeline.run`` of the pipeline case
    (tests/test_mesh_embed.py:466)."""
    tmp = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    (tmp / "ref4.py").write_text(_REF4)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    procs = ranks_mod.start("geo", 4, tmp / "in.npz", tmp / "ranks")
    ref4 = subprocess.Popen(
        [sys.executable, str(tmp / "ref4.py"), str(tmp / "in.npz"),
         str(tmp / "ref4.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        x, w = jnp.asarray(inp["blob_x"]), jnp.asarray(inp["blob_w"])
        ref = dict(
            grid=ref_quantize.fit_grid(jnp.asarray(inp["geo_pts"]), 16),
            table=_single_device_table(inp),
            pipe=ref_pipeline.run(ref_pipeline.SnsConfig(**PIPE),
                                  jnp.asarray(inp["pipe_pts"]),
                                  umap_cfg=ref_umap.UmapConfig(**PIPE_UMAP)),
            umap={e: np.asarray(ref_umap.run_umap(
                jax.random.key(7), x,
                ref_umap.UmapConfig(n_epochs=e, **BLOB_UMAP), weights=w))
                for e in (1, 3)})
        outs = ranks_mod.collect(procs, tmp / "ranks")
        log = ref4.communicate(timeout=300)[0]
    finally:
        for p in procs + [ref4]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert ref4.returncode == 0, log
    return inp, ref, outs, dict(np.load(tmp / "ref4.npz"))


def _single_device_table(inp):
    """The reference's single-device fold of all the points."""
    pts = jnp.asarray(inp["geo_pts"])
    grid = ref_quantize.GridSpec(dims=4, bins=16, lo=inp["geo_lo"],
                                 hi=inp["geo_hi"])
    hi, lo = ref_quantize.points_to_keys(grid, pts)
    sk = ref_sketch.init(jax.random.key(0), GEO["rows"], GEO["log2_cols"])
    return np.asarray(ref_sketch.update_sorted(sk, hi, lo).table)


def _hh_eq(out, prefix, want):
    for f in HH_FIELDS:
        np.testing.assert_array_equal(
            out[f"{prefix}_{f}"].astype(np.float64),
            np.asarray(want[f] if isinstance(want, dict)
                       else getattr(want, f)).astype(np.float64), err_msg=f)


# ------------------------------------------------- the hash draw (Queue 3)
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_shared_params_are_the_reference_draw(seed):
    got = geo.shared_params(seed, 16, "cpu")
    want = ref_hashing.make_params(jax.random.key(seed), 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))


def test_run_without_hash_params_gives_reference_table_and_hh(run):
    """Nothing fed: ``pipeline.run(cfg, pts, device="cpu")`` gives the
    reference's heavy hitters, representatives and coverage bit for bit,
    and a fold at the default draw the reference's sketch table."""
    inp, ref, _, _ = run
    ref_pipe = ref["pipe"]
    got = pipeline.run(pipeline.SnsConfig(**PIPE), inp["pipe_pts"],
                       device="cpu", umap_cfg=umap.UmapConfig(**PIPE_UMAP))
    for f in HH_FIELDS:
        np.testing.assert_array_equal(
            getattr(got.hh, f).numpy().astype(np.float64),
            np.asarray(getattr(ref_pipe.hh, f)).astype(np.float64),
            err_msg=f)
    np.testing.assert_array_equal(got.reps.points.numpy(),
                                  np.asarray(ref_pipe.reps.points))
    assert got.coverage == ref_pipe.coverage
    pts = torch.from_numpy(inp["geo_pts"])
    grid = quantize.GridSpec(dims=4, bins=16, lo=inp["geo_lo"],
                             hi=inp["geo_hi"])
    hi, lo = quantize.points_to_keys(grid, pts)
    table = sketch.update_sorted(
        sketch.init(geo.shared_params(0, 8, "cpu"), 12), hi, lo).table
    np.testing.assert_array_equal(table.numpy(), ref["table"])


# -------------------------------------------------------- mesh helpers
def test_row_block_sizing():
    assert mesh_mod.row_block(16, 4) == (4, 16)
    assert mesh_mod.row_block(17, 4) == (5, 20)
    assert mesh_mod.row_block(3, 8) == (1, 8)
    rows_per, n_pad = mesh_mod.row_block(203, 8)
    assert n_pad >= 203 and n_pad == rows_per * 8


def test_resolve_mesh_normalizes_specs(run):
    """None stays None; an int needs the process group and must be its
    size; a DeviceMesh passes through; anything else is a TypeError.
    On the ranks: 4 builds the 1-D embed mesh, 3 is refused."""
    assert mesh_mod.resolve_mesh(None) is None
    with pytest.raises(TypeError):
        mesh_mod.resolve_mesh("eight")
    with pytest.raises(ValueError, match="initialized"):
        mesh_mod.resolve_mesh(4)
    assert mesh_mod.pick_backend("cpu") == "gloo"
    assert mesh_mod.pick_backend("cuda", ranks_per_card=4) == "gloo"
    assert mesh_mod.pick_backend("cuda") == "nccl"
    _, _, outs, _ = run
    for o in outs:
        assert list(o["embed_names"]) == [mesh_mod.EMBED_AXIS]
        assert bool(o["embed_passes"]) and bool(o["embed_refuses"])
        assert int(o["axis_size"]) == 4
    assert sorted(int(o["linear_index"]) for o in outs) == [0, 1, 2, 3]


# ------------------------------------------------------ the sketch tier
@pytest.mark.parametrize("rank", range(4))
def test_geo_extract_merged_table_is_the_single_device_fold(run, rank):
    _, ref, outs, _ = run
    np.testing.assert_array_equal(outs[rank]["one_table"], ref["table"])


@pytest.mark.parametrize("field", ["total", "evict", "hh", "table"])
def test_geo_extract_equals_reference_4_device_mesh(run, field):
    _, _, outs, ref4 = run
    for o in outs:
        if field == "hh":
            _hh_eq(o, "one", {f: ref4[f"hh_{f}"] for f in HH_FIELDS})
        else:
            np.testing.assert_array_equal(o[f"one_{field}"], ref4[field])
    assert float(ref4["total"]) == 8000.0


def test_geo_extract_from_shards_table_is_the_one_shot_table(run):
    """Each rank's shard in 4 batches through the fold: the merged table
    equals the one-shot table, the count the whole stream's; every rank
    holds the same heavy hitters."""
    _, _, outs, _ = run
    for o in outs:
        np.testing.assert_array_equal(o["stream_table"], o["one_table"])
        assert float(o["stream_total"]) == 8000.0
        _hh_eq(o, "stream", {f: outs[0][f"stream_{f}"] for f in HH_FIELDS})


def test_pipeline_run_on_the_mesh(run):
    """``run(mesh=)``: the grid from the shards' min/max equals fit_grid
    on the whole array bit for bit, the heavy hitters equal geo_extract's
    on every rank, and coverage is over all 8000 points;
    ``run_streaming(mesh=, shard_fn=)`` gives the streaming extract's."""
    _, ref, outs, _ = run
    for o in outs:
        np.testing.assert_array_equal(o["run_lo"], np.asarray(ref["grid"].lo))
        np.testing.assert_array_equal(o["run_hi"], np.asarray(ref["grid"].hi))
        _hh_eq(o, "run", {f: o[f"one_{f}"] for f in HH_FIELDS})
        _hh_eq(o, "runs", {f: o[f"stream_{f}"] for f in HH_FIELDS})
        assert float(o["run_coverage"]) == pytest.approx(
            float(o["one_count"].sum()) / 8000.0, rel=1e-6)


# ---------------------------------------------------- the sharded layout
@pytest.mark.parametrize("seed,n,e,s", [
    (0, 2, 1, 1), (1, 17, 60, 4), (2, 80, 400, 9), (3, 5, 40, 8),
    (4, 33, 1, 3), (5, 64, 250, 4), (6, 3, 7, 9), (7, 50, 333, 7)])
def test_shard_edge_layout_reduces_like_np_add_at(seed, n, e, s):
    """Over src-sorted COO multisets (duplicate edges, rows without
    edges, empty blocks, block counts that do not divide N): the blocks'
    local src reductions stitched together equal np.add.at on src, and
    the sum of the blocks' full-length dst partials np.add.at on dst."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n, e))
    dst = rng.integers(0, n, e)
    vals = rng.normal(size=(e, 2)).astype(np.float32)
    lay = coo.shard_edge_layout(src, dst, n, s)
    rows_per, n_pad = lay.rows_per_shard, lay.n_padded
    assert lay.n_shards == s and n_pad == rows_per * s >= n
    v = coo.shard_payload(lay, torch.from_numpy(vals))      # (S, Ep, 2)
    assert float(v[torch.from_numpy(~lay.edge_mask)].abs().sum()) == 0.0
    ids, mask = lay.edge_ids, lay.edge_mask
    np.testing.assert_array_equal(lay.src[mask], src[ids[mask]])
    np.testing.assert_array_equal(np.sort(ids[mask]), np.arange(e))
    by_src = torch.cat([coo.segment_reduce(
        v[b], torch.from_numpy(lay.src_bounds[b])) for b in range(s)])
    by_dst = sum(coo.segment_reduce(
        v[b][torch.from_numpy(lay.dst_order[b])],
        torch.from_numpy(lay.dst_bounds[b])) for b in range(s))
    blk = lay.block(s - 1, "cpu")
    torch.testing.assert_close(coo.shard_payload(blk, torch.from_numpy(vals)),
                               v[s - 1], rtol=0, atol=0)
    ref_src = np.zeros((n_pad, 2))
    ref_dst = np.zeros((n_pad, 2))
    np.add.at(ref_src, src, vals.astype(np.float64))
    np.add.at(ref_dst, dst, vals.astype(np.float64))
    scale = max(1.0, np.abs(ref_src).max(), np.abs(ref_dst).max())
    assert np.abs(by_src.numpy() - ref_src).max() <= 1e-4 * scale
    assert np.abs(by_dst.numpy() - ref_dst).max() <= 1e-4 * scale


def test_shard_edge_layout_rejects_unsorted_src():
    with pytest.raises(ValueError, match="sorted"):
        coo.shard_edge_layout(np.array([3, 1]), np.array([0, 0]), 4, 2)


# ------------------------------------------------------- the sharded UMAP
def test_knn_graph_mesh_matches_single_device(run):
    """Every rank's gathered graph equals the single-device build bit
    for bit, indices and distances; the indices are the reference's."""
    inp, _, outs, _ = run
    x = torch.from_numpy(inp["blob_x"])
    idx, dist = neighbors.knn_graph(x, 10, block=64)
    ridx, _ = ref_neighbors.knn_graph(jnp.asarray(inp["blob_x"]), 10,
                                      block=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    for o in outs:
        np.testing.assert_array_equal(o["knn_idx"], idx.numpy())
        np.testing.assert_array_equal(o["knn_dist"], dist.numpy())


@pytest.mark.parametrize("epochs,tol", [(1, 1e-4), (3, 2e-2)])
def test_run_umap_mesh_matches_reference_prefix(run, epochs, tol):
    """Given the reference's init and negatives: one epoch within
    1e-4·scale (any draw misalignment would be O(1)), three within
    2e-2·scale, on every rank."""
    _, ref, outs, _ = run
    want = ref["umap"][epochs]
    scale = max(1.0, float(np.abs(want).max()))
    for o in outs:
        assert o[f"umap_{epochs}"].shape == want.shape
        assert float(np.abs(o[f"umap_{epochs}"] - want).max()) <= tol * scale


def test_pipeline_embed_mesh_end_to_end_matches_reference(run):
    """``SnsConfig.embed_mesh`` end to end on every rank (sketch → HH →
    reps → sharded UMAP), given only the reference's UMAP draws: the hash
    parameters and the jitter are the port's own, now the reference's
    bits."""
    _, ref, outs, _ = run
    want = np.asarray(ref["pipe"].embedding)
    scale = max(1.0, float(np.abs(want).max()))
    for o in outs:
        assert o["pipe_embedding"].shape == want.shape
        assert float(np.abs(o["pipe_embedding"] - want).max()) <= \
            1e-3 * scale


def test_hh_keys_pack_like_the_reference(run):
    """The heavy hitters' packed keys on every rank as uint64: the same
    set as the reference mesh's, whatever the gather order."""
    _, _, outs, ref4 = run
    want = np.sort(np.asarray(u64.sort_key((
        torch.from_numpy(ref4["hh_key_hi"].astype(np.int64)),
        torch.from_numpy(ref4["hh_key_lo"].astype(np.int64))))))
    for o in outs:
        got = u64.sort_key((torch.from_numpy(o["one_key_hi"]),
                            torch.from_numpy(o["one_key_lo"])))
        np.testing.assert_array_equal(np.sort(got.numpy()), want)


def test_umap_mesh_epoch_speaks_one_gather_and_one_reduce(tmp_path,
                                                           monkeypatch):
    """The collective contract (tests/test_mesh_embed.py:405): each epoch
    of the sharded loop is one all-gather of the blocks and one
    all-reduce of the dst partial, plus the final gather; on one rank the
    loop gives the single-device run's bits."""
    x, w = _blob_data(n=117)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    cfg = umap.UmapConfig(n_epochs=3, n_neighbors=8, block=64)
    idx, dist = neighbors.knn_graph(x, 8, block=64)
    edges, memb = umap.fuzzy_simplicial_set(idx, dist, weights=w)

    want = umap.optimize_embedding(
        edges, memb, len(x), cfg, generator=torch.Generator().manual_seed(3))
    calls = {"all_gather": 0, "all_reduce": 0}
    for name in calls:
        fn = getattr(mesh_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mesh_mod, name, counted)
    m = mesh_mod.init_mesh(0, 1, f"file://{tmp_path / 'rendezvous'}", (1,),
                           (mesh_mod.EMBED_AXIS,), backend="gloo")
    try:
        got = umap.optimize_embedding(
            edges, memb, len(x), cfg, mesh=m,
            generator=torch.Generator().manual_seed(3))
    finally:
        torch.distributed.destroy_process_group()
    assert calls == {"all_gather": cfg.n_epochs + 1,
                     "all_reduce": cfg.n_epochs}
    assert torch.equal(got, want)
