"""The port's mesh-parallel sparse tSNE and approximate kNN
(``tsne.run_tsne(mesh=)``, ``sparse_grad_shard``, ``ann``'s mesh build)
against the JAX reference and the port's single-device path on the CPU.

Four gloo CPU ranks (tests/_torch_mesh_ranks.py, job ``tsne``) run a 1-D
embed mesh; the reference's ``sparse_grad_shard`` and mesh ANN build run
on a 4-device XLA mesh in a subprocess (the device count must be set
before jax starts).  Both start once, together, for the whole module.
Data: tests/test_mesh_embed.py's two weighted blobs at N = 203, which 4
does not divide.

Bars, as the reference pins them (tests/test_mesh_embed.py), with
scale = max(1, max|value|); the gradient's is tighter:

* the sharded gradient within 1e-4·max|grad| of the reference's
  ``sparse_grad`` and of its ``sparse_grad_shard`` (:222; the
  reference's scale would make it an absolute 1e-4 against entries of
  ~1e-2), padded rows exactly 0, the KL within 1e-3;
* the 8-iteration prefix from a fed init within 2e-2·scale, KL atol
  1e-2, at grid_interval 0.0 and 0.5 (:256);
* 150 iterations finite, descending, and within 2.5× of the
  single-device run's best KL (:275);
* the ANN mesh graph equal to the port's single-device graph bit for bit
  (:207), and given the reference's draws, overlapping the reference's
  mesh build ≥ 0.99 (as tests/test_torch_ann.py does on one device);
* the pipeline with ``embed_mesh`` within 2e-2·scale of the
  single-device pipeline after 8 iterations, from the same generator.
"""
import dataclasses
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
from repro.core import ann as ref_ann
from repro.core import tsne as ref_tsne
from repro_torch import carry
from repro_torch.core import ann, coo, neighbors, pipeline, tsne
from repro_torch.core import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ANN_N, ANN_D, ANN_K = 777, 6, 12

_REF4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import ann, tsne
    from repro.core import mesh as mesh_mod
    inp = np.load(sys.argv[1])
    mesh = mesh_mod.make_embed_mesh(4)
    axis = mesh_mod.mesh_axis(mesh)
    P = mesh_mod.P
    n = inp["blob_x"].shape[0]
    sp = tsne.SparseP(*[jnp.asarray(inp[f"sp_{f}"])
                        for f in tsne.SparseP._fields])
    ssp = tsne.shard_sparse_p(sp, n, 4)
    _, n_pad = mesh_mod.row_block(n, 4)
    yp = jnp.pad(jnp.asarray(inp["grad_y"]), [(0, n_pad - n), (0, 0)])
    specs = jax.tree_util.tree_map(lambda _: P(axis), ssp)

    @mesh_mod.shard_map_compat(mesh=mesh, in_specs=(P(axis), specs, P()),
                               out_specs=(P(axis), P()))
    def spmd(y_blk, ssp_, y_full):
        lay = jax.tree_util.tree_map(lambda a: a[0], ssp_.layout)
        return tsne.sparse_grad_shard(y_blk, lay, ssp_.val[0], y_full,
                                      12.0, 32, axis, n)
    g, kl = jax.jit(spmd)(yp, ssp, yp)
    idx, _ = ann.ann_knn_graph(jnp.asarray(inp["ann_x"]), int(inp["ann_k"]),
                               ann.AnnConfig(probes=1, bucket=32), mesh=mesh)
    np.savez(sys.argv[2], grad=np.asarray(g), kl=np.asarray(kl),
             ann_idx=np.asarray(idx))
""")


def _blob_data(n=203, dims=5, seed=0):
    """tests/test_mesh_embed.py's two weighted blobs at a non-dividing N."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, dims)),
                        rng.normal(6, 1, (n - n // 2, dims))])
    w = rng.integers(1, 50, n).astype(np.float32)
    return x.astype(np.float32), w


def _inputs():
    """Every input of the ranks: the blobs, the reference's P of them
    (k 10, perplexity 10), a y for the gradient, the reference's cold
    starts of the prefix and long runs, the reference's ANN draws of the
    uniform set and the pipeline's points."""
    x, w = _blob_data()
    n = len(x)
    sp = ref_tsne.build_sparse_p(jnp.asarray(x), 10.0, k=10,
                                 weights=jnp.asarray(w))
    xa = np.random.default_rng(5).uniform(
        size=(ANN_N, ANN_D)).astype(np.float32)
    rot, off, slots = par.ann_draws(ref_ann.AnnConfig(**ranks_mod.ANN_DRAWN),
                                    ANN_N, ANN_D, ANN_K)
    return dict(
        blob_x=x, blob_w=w,
        sp_src=np.asarray(sp.src).astype(np.int64),
        sp_dst=np.asarray(sp.dst).astype(np.int64),
        sp_val=np.asarray(sp.val), sp_bounds=np.asarray(sp.bounds),
        grad_y=np.random.default_rng(1).normal(0, 1e-2, (n, 2)).astype(
            np.float32),
        prefix_init=np.asarray(1e-4 * jax.random.normal(
            jax.random.key(3), (n, 2))),
        long_init=np.asarray(1e-4 * jax.random.normal(
            jax.random.key(5), (n, 2))),
        ann_x=xa, ann_k=np.int64(ANN_K), ann_rot=rot, ann_off=off,
        ann_slots=slots,
        pipe_pts=np.random.default_rng(4).uniform(
            0, 1, size=(4096, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the in-process references, the four ranks' outputs, the
    reference's 4-device mesh).  The ranks and the reference's
    subprocess start first and run while this process computes the
    reference's single-device gradient and runs and the port's
    single-device pipeline."""
    tmp = tmp_path_factory.mktemp("mesh_tsne")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    (tmp / "ref4.py").write_text(_REF4)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))
    procs = ranks_mod.start("tsne", WORLD, tmp / "in.npz", tmp / "ranks")
    ref4 = subprocess.Popen(
        [sys.executable, str(tmp / "ref4.py"), str(tmp / "in.npz"),
         str(tmp / "ref4.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        x, w = jnp.asarray(inp["blob_x"]), jnp.asarray(inp["blob_w"])
        sp = ref_tsne.SparseP(*[jnp.asarray(inp[f"sp_{f}"])
                                for f in ref_tsne.SparseP._fields])
        g, kl = ref_tsne.sparse_grad(jnp.asarray(inp["grad_y"]), sp, 12.0,
                                     grid_size=32)
        ref = {"grad": np.asarray(g), "grad_kl": float(kl)}
        for gi in (0.0, 0.5):
            cfg = ref_tsne.TsneConfig(grid_interval=gi,
                                      **ranks_mod.TSNE_PREFIX)
            y, k = ref_tsne.run_tsne(jax.random.key(3), x, cfg, weights=w,
                                     init=jnp.asarray(inp["prefix_init"]))
            ref[f"prefix_{gi}"], ref[f"prefix_kl_{gi}"] = \
                np.asarray(y), np.asarray(k)
        _, k = ref_tsne.run_tsne(jax.random.key(5), x,
                                 ref_tsne.TsneConfig(**ranks_mod.TSNE_LONG),
                                 weights=w,
                                 init=jnp.asarray(inp["long_init"]))
        ref["long_kl"] = np.asarray(k)
        cfg = pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=64,
                                 embedder="tsne", embed_backend="sparse")
        ref["pipe"] = pipeline.run(cfg, inp["pipe_pts"], device="cpu",
                                   tsne_cfg=tsne.TsneConfig(
                                       n_iter=8, learning_rate=10.0))
        outs = ranks_mod.collect(procs, tmp / "ranks")
        log = ref4.communicate(timeout=300)[0]
    finally:
        for p in procs + [ref4]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert ref4.returncode == 0, log
    return inp, ref, outs, dict(np.load(tmp / "ref4.npz"))


def _overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(r) & set(s)) / len(r)
                          for r, s in zip(a, b)]))


# ------------------------------------------------ the sharded gradient
@pytest.mark.parametrize("against", ["sparse_grad", "sparse_grad_shard"])
def test_sharded_gradient_matches_reference(run, against):
    """Every rank's gathered gradient within 1e-4·max|grad| of the
    reference's single-device ``sparse_grad`` and of its
    ``sparse_grad_shard`` on the 4-device mesh (padded rows included)."""
    inp, ref, outs, ref4 = run
    n = inp["blob_x"].shape[0]
    want = ref["grad"] if against == "sparse_grad" else ref4["grad"][:n]
    # relative to the largest entry (the reference's max(1, ·) would be
    # an absolute 1e-4 here, where the entries are ~1e-2)
    scale = float(np.abs(want).max())
    for o in outs:
        assert o["grad"].shape == ref4["grad"].shape
        assert float(np.abs(o["grad"][:n] - want).max()) <= 1e-4 * scale


def test_sharded_gradient_padded_rows_and_kl(run):
    """Padded rows get exactly 0; the KL within 1e-3 of the reference's,
    the same on every rank."""
    inp, ref, outs, ref4 = run
    n = inp["blob_x"].shape[0]
    for o in outs:
        assert o["grad"].shape[0] > n
        assert float(np.abs(o["grad"][n:]).max()) == 0.0
        assert abs(float(o["grad_kl"]) - ref["grad_kl"]) <= 1e-3
        assert abs(float(o["grad_kl"]) - float(ref4["kl"])) <= 1e-3
        assert float(o["grad_kl"]) == float(outs[0]["grad_kl"])


@pytest.mark.parametrize("n,shards", [(203, 4), (203, 3), (17, 4), (5, 4)])
def test_device_block_cut_equals_shard_sparse_p(n, shards):
    """The device cut of each block equals ``shard_sparse_p``'s block,
    padding included (n = 5 on 4 ranks: the last holds no row), but for
    the bounds: the host layout hands the padding to the last row, the
    device cut to no row.  The row sums over both bounds agree bit for
    bit."""
    x, w = _blob_data(n=n)
    sp = tsne.build_sparse_p(torch.from_numpy(x), 10.0, k=10,
                             weights=torch.from_numpy(w))
    ssp = tsne.shard_sparse_p(sp, n, shards)
    payload = torch.from_numpy(np.random.default_rng(n).normal(
        size=(sp.src.shape[0], 2)).astype(np.float32))
    for s in range(shards):
        want, got = ssp.block(s, "cpu"), tsne.sparse_p_block(sp, n, shards, s)
        assert got.row_offset == want.row_offset
        for f in ("src", "dst", "val"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (s, f)
        real = int(ssp.layout.edge_mask[s].sum())
        assert got.bounds.dtype == want.bounds.dtype
        assert torch.equal(got.bounds, want.bounds.clamp(max=real)), s
        vals = coo.shard_payload(ssp.layout.block(s, "cpu"), payload)
        assert torch.equal(coo.segment_reduce(vals, got.bounds),
                           coo.segment_reduce(vals, want.bounds)), s


# ------------------------------------------------------- the optimizer
@pytest.mark.parametrize("grid_interval", [0.0, 0.5])
def test_run_tsne_mesh_prefix_matches_reference(run, grid_interval):
    """8 iterations from the reference's cold start, fixed and adaptive
    G: within 2e-2·scale of the reference's single-device run, KL atol
    1e-2, every rank the whole embedding."""
    _, ref, outs, _ = run
    want = ref[f"prefix_{grid_interval}"]
    scale = max(1.0, float(np.abs(want).max()))
    for o in outs:
        got = o[f"prefix_{grid_interval}"]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 2e-2 * scale
        np.testing.assert_allclose(o[f"prefix_kl_{grid_interval}"],
                                   ref[f"prefix_kl_{grid_interval}"],
                                   atol=1e-2)


def test_run_tsne_mesh_long_run_stays_stable_and_descends(run):
    """150 iterations: finite on every rank, well below the
    post-exaggeration start, and within 2.5× of the single-device run's
    best KL (the reference's quality contract)."""
    _, ref, outs, _ = run
    k1 = ref["long_kl"]
    q1 = float(k1[45:].min())
    assert np.isfinite(k1).all() and q1 < 0.7 * float(k1[45])
    for o in outs:
        k2 = o["long_kl"]
        assert k2.shape == k1.shape and np.isfinite(k2).all()
        q2 = float(k2[45:].min())
        assert q2 < 0.7 * float(k2[45])
        assert max(q1, q2) <= 2.5 * min(q1, q2), (q1, q2)
        np.testing.assert_array_equal(k2, outs[0]["long_kl"])


# ------------------------------------------------------ the ANN build
@pytest.mark.parametrize("n", [203, 100])
def test_ann_mesh_graph_is_the_single_device_graph(run, n):
    """Bit for bit, indices and distances, on every rank.  B = 128: at
    N = 203 two tiles (ranks 2 and 3 score junk tiles only), at N = 100
    one (ranks 1-3)."""
    inp, _, outs, _ = run
    x = torch.from_numpy(inp["blob_x"][:n])
    idx, dist = neighbors.knn_graph(x, 10, method="ann")
    for o in outs:
        np.testing.assert_array_equal(o[f"ann_idx_{n}"], idx.numpy())
        np.testing.assert_array_equal(o[f"ann_dist_{n}"], dist.numpy())


def test_ann_mesh_graph_given_reference_draws(run):
    """One probe of 32-row tiles on uniform points, so NN-descent does
    the work: given the reference's draws the mesh graph equals the
    port's single-device graph bit for bit and overlaps the reference's
    4-device mesh build ≥ 0.99."""
    inp, _, outs, ref4 = run
    draws = carry.ann_draws_from_numpy(inp["ann_rot"], inp["ann_off"],
                                       inp["ann_slots"])
    stats = {}
    idx, dist = ann.ann_knn_graph(torch.from_numpy(inp["ann_x"]), ANN_K,
                                  ann.AnnConfig(**ranks_mod.ANN_DRAWN),
                                  draws=draws, stats=stats)
    assert stats["descent_iters"] >= 2
    for o in outs:
        np.testing.assert_array_equal(o["drawn_idx"], idx.numpy())
        np.testing.assert_array_equal(o["drawn_dist"], dist.numpy())
        assert _overlap(o["drawn_idx"], ref4["ann_idx"]) >= 0.99


# -------------------------------------------------------- the pipeline
def test_pipeline_embed_mesh_tsne_matches_single_device(run):
    """``SnsConfig(embedder="tsne", embed_mesh=)`` end to end on every
    rank: the whole embedding, within 2e-2·scale of the port's
    single-device pipeline after 8 iterations from the same generator,
    KL atol 1e-2."""
    _, ref, outs, _ = run
    want = ref["pipe"].embedding.numpy()
    scale = max(1.0, float(np.abs(want).max()))
    for o in outs:
        assert o["pipe_embedding"].shape == want.shape
        assert float(np.abs(o["pipe_embedding"] - want).max()) <= \
            2e-2 * scale
        np.testing.assert_allclose(o["pipe_kl"], ref["pipe"].kl_trace.numpy(),
                                   atol=1e-2)


# ------------------------------------------------ the collective contract
def _counting(monkeypatch):
    calls = {"all_gather": 0, "all_reduce": 0}
    for name in calls:
        fn = getattr(mesh_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mesh_mod, name, counted)
    return calls


@pytest.fixture
def one_rank(tmp_path):
    m = mesh_mod.init_mesh(0, 1, f"file://{tmp_path / 'rendezvous'}", (1,),
                           (mesh_mod.EMBED_AXIS,), backend="gloo")
    try:
        yield m
    finally:
        torch.distributed.destroy_process_group()


def test_tsne_iteration_speaks_one_gather_and_three_reduces(one_rank,
                                                           monkeypatch):
    """The collective contract (tests/test_mesh_embed.py:367 pins one
    all_gather and five psums): each iteration is one all-gather of the
    blocks and three all-reduces (the grid with the KL's partials, Z,
    the centering mean), counted as the difference of an 8- and a
    4-iteration run; an adaptive stage adds one all-reduce.  The exact
    backends refuse a mesh with the reference's message."""
    x, w = _blob_data()
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    counts = {}
    calls = _counting(monkeypatch)
    for it in (4, 8):
        for k in calls:
            calls[k] = 0
        cfg = tsne.TsneConfig(backend="sparse", n_iter=it, grid_size=32,
                              knn=10)
        tsne.run_tsne(x, cfg, weights=w, mesh=one_rank,
                      generator=torch.Generator().manual_seed(0))
        counts[it] = dict(calls)
    assert counts[8]["all_gather"] - counts[4]["all_gather"] == 4
    assert counts[8]["all_reduce"] - counts[4]["all_reduce"] == 3 * 4
    for k in calls:
        calls[k] = 0
    cfg = tsne.TsneConfig(backend="sparse", n_iter=8, grid_size=32, knn=10,
                          grid_interval=0.5, adaptive_interval=4)
    tsne.run_tsne(x, cfg, weights=w, mesh=one_rank,
                  generator=torch.Generator().manual_seed(0))
    assert calls["all_reduce"] == counts[8]["all_reduce"] + 1
    with pytest.raises(ValueError, match="needs backend='sparse'"):
        tsne.run_tsne(x, dataclasses.replace(cfg, backend="dense"),
                      mesh=one_rank)


def test_descent_round_speaks_one_gather_and_one_reduce(one_rank,
                                                        monkeypatch):
    """Each NN-descent round on a mesh is one all-gather of the
    neighbour blocks and one all-reduce of the change count; stage 1 one
    all-gather a probe, and one more makes the graph whole.  On one rank
    the graph equals the single-device build bit for bit."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(500, 6)).astype(np.float32))
    cfg = ann.AnnConfig(probes=2, bucket=32)
    want = ann.ann_knn_graph(x, 10, cfg)
    calls = _counting(monkeypatch)
    stats = {}
    got = ann.ann_knn_graph(x, 10, cfg, mesh=one_rank, stats=stats)
    rounds = stats["descent_iters"]
    assert rounds >= 2
    assert calls == {"all_gather": cfg.probes + rounds + 1,
                     "all_reduce": rounds}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
