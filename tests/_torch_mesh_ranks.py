"""One rank of the port's mesh tier, for tests/test_torch_mesh.py and
tests/test_torch_mesh_tsne.py (CPU ranks, gloo) and
tests/test_torch_cuda_mesh.py (card ranks).  Imports no jax: the card
machine has none.

    python tests/_torch_mesh_ranks.py JOB RANK WORLD INIT_METHOD IN OUT

``JOB`` names a function below; it reads its inputs from the ``IN``
.npz, and every rank writes what it computed to ``OUT/rank<R>.npz``
(on an error: the traceback to ``OUT/rank<R>.err`` and exit code 1).
:func:`start` starts the ranks, :func:`collect` waits for them.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
GEO_AXES = ("data", "pod")          # innermost first, as tests/test_geo.py


def start(job: str, world: int, inputs: Path, out: Path) -> list:
    """Start ``job`` on ``world`` rank processes that rendezvous through
    a file in ``out``; :func:`collect` waits for them."""
    out.mkdir(parents=True, exist_ok=True)
    init = f"file://{out / 'rendezvous'}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(HERE.parent / "src")] + ([env["PYTHONPATH"]]
                                      if env.get("PYTHONPATH") else []))
    env.setdefault("OMP_NUM_THREADS", "1")
    # every rank runs on this host: rendezvous over loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__)), job, str(r), str(world), init,
         str(inputs), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list, out: Path, timeout: float = 240.0) -> list:
    """Each rank's outputs (dicts of arrays).  Raises with the ranks'
    tracebacks if any rank fails or outlives ``timeout`` seconds (every
    rank is killed then)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    errs = [(r, (out / f"rank{r}.err").read_text() if
             (out / f"rank{r}.err").exists() else logs[r])
            for r, p in enumerate(procs) if p.returncode != 0]
    if errs:
        raise RuntimeError("\n".join(f"rank {r}:\n{e}" for r, e in errs))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def spawn(job: str, world: int, inputs: Path, out: Path,
          timeout: float = 240.0) -> list:
    """:func:`start` then :func:`collect`."""
    return collect(start(job, world, inputs, out), out, timeout)


def _hh(prefix: str, hh) -> dict:
    return {f"{prefix}_{f}": getattr(hh, f).cpu().numpy()
            for f in hh._fields}


def geo(rank: int, world: int, init: str, inp: dict) -> dict:
    """The sketch tier on a (2, 2) ("pod", "data") mesh of CPU ranks, and
    the UMAP half on a 1-D embed mesh over the same ranks."""
    import torch
    from repro_torch.core import geo as geo_mod
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import neighbors, pipeline, quantize, umap
    mesh = mesh_mod.init_mesh(rank, world, init, (2, 2), ("pod", "data"),
                              backend=mesh_mod.pick_backend("cpu"))
    out = {"linear_index": np.int64(mesh_mod.linear_index(mesh, GEO_AXES)),
           "axis_size": np.int64(mesh_mod.axis_size(mesh, GEO_AXES))}
    pts = inp["geo_pts"]
    per, _ = mesh_mod.row_block(pts.shape[0], world)
    idx = int(out["linear_index"])
    shard = pts[idx * per:(idx + 1) * per]
    grid = quantize.GridSpec(dims=pts.shape[1], bins=16,
                             lo=inp["geo_lo"], hi=inp["geo_hi"])
    kw = dict(rows=8, log2_cols=12, top_k=64, data_axes=GEO_AXES, seed=0,
              device="cpu")
    res = geo_mod.geo_extract(mesh, grid, shard, **kw)
    out.update(_hh("one", res.hh), one_table=res.merged.table.numpy(),
               one_total=res.total_count.numpy(),
               one_evict=res.evict_max.numpy())
    chunk = -(-per // 4)

    def shard_fn(i, b):
        lo = i * per + b * chunk
        return pts[lo:min(lo + chunk, (i + 1) * per)], None
    res = geo_mod.geo_extract_from_shards(mesh, grid, shard_fn,
                                          num_batches=4, **kw)
    out.update(_hh("stream", res.hh), stream_table=res.merged.table.numpy(),
               stream_total=res.total_count.numpy(),
               stream_evict=res.evict_max.numpy())

    cfg = pipeline.SnsConfig(bins=16, rows=8, log2_cols=12, top_k=64,
                             max_replicas=2)
    ucfg = umap.UmapConfig(n_neighbors=5, n_epochs=1)
    r = pipeline.run(cfg, shard, mesh=mesh, data_axes=GEO_AXES,
                     umap_cfg=ucfg, device="cpu")
    out.update(_hh("run", r.hh), run_lo=np.asarray(r.grid.lo),
               run_hi=np.asarray(r.grid.hi), run_coverage=r.coverage)
    r = pipeline.run_streaming(cfg, mesh=mesh, data_axes=GEO_AXES,
                               shard_fn=shard_fn, num_batches=4, grid=grid,
                               umap_cfg=ucfg, device="cpu")
    out.update(_hh("runs", r.hh), runs_coverage=r.coverage)

    emesh = mesh_mod.resolve_mesh(world)
    out["embed_names"] = np.asarray(emesh.mesh_dim_names)
    out["embed_passes"] = np.bool_(mesh_mod.resolve_mesh(emesh) is emesh)
    try:
        mesh_mod.resolve_mesh(world - 1)
        out["embed_refuses"] = np.bool_(False)
    except ValueError:
        out["embed_refuses"] = np.bool_(True)
    x, w = torch.from_numpy(inp["blob_x"]), torch.from_numpy(inp["blob_w"])
    i1, d1 = neighbors.knn_graph(x, 10, block=64, mesh=emesh)
    out.update(knn_idx=i1.numpy(), knn_dist=d1.numpy())
    init_ = torch.from_numpy(inp["umap_init"])
    negs = torch.from_numpy(inp["umap_negs"]).long()
    for epochs in (1, 3):
        u = umap.run_umap(x, umap.UmapConfig(n_epochs=epochs, n_neighbors=10,
                                             block=64),
                          weights=w, mesh=emesh, init=init_,
                          negatives=negs[:epochs])
        out[f"umap_{epochs}"] = u.numpy()
    pcfg = pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=64,
                              embed_mesh=emesh)
    draws = pipeline.Draws(umap_init=torch.from_numpy(inp["pipe_init"]),
                           negatives=torch.from_numpy(
                               inp["pipe_negs"]).long())
    r = pipeline.run(pcfg, inp["pipe_pts"], device="cpu", draws=draws,
                     umap_cfg=umap.UmapConfig(n_epochs=2, n_neighbors=8))
    out["pipe_embedding"] = r.embedding.numpy()
    return out


def card(rank: int, world: int, init: str, inp: dict) -> dict:
    """geo_extract on ranks on the card: ``world`` gloo ranks sharing
    cuda:0 when the inputs say ``shared``, else one nccl rank per card.
    Returns the merged table and the launches of K7 and K8."""
    import torch
    from repro_torch.core import geo as geo_mod
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import quantize
    from repro_torch.kernels import LAUNCHES
    shared = bool(inp["shared"])
    dev = torch.device("cuda", 0 if shared else rank)
    torch.cuda.set_device(dev)
    mesh = mesh_mod.init_mesh(
        rank, world, init, (1, world), ("pod", "data"),
        backend=mesh_mod.pick_backend(dev, world if shared else 1))
    pts = inp["pts"]
    per, _ = mesh_mod.row_block(pts.shape[0], world)
    idx = mesh_mod.linear_index(mesh, GEO_AXES)
    grid = quantize.GridSpec(dims=pts.shape[1], bins=int(inp["bins"]),
                             lo=inp["lo"], hi=inp["hi"])
    LAUNCHES.clear()
    res = geo_mod.geo_extract(mesh, grid, pts[idx * per:(idx + 1) * per],
                              rows=16, log2_cols=18, top_k=512,
                              data_axes=GEO_AXES, seed=0, device=dev)
    torch.cuda.synchronize()
    return {"table": res.merged.table.cpu().numpy(),
            "total": res.total_count.cpu().numpy(),
            "k7": np.int64(LAUNCHES["sketch_update_table"]),
            "k8": np.int64(LAUNCHES["sketch_estimate_table"]),
            **_hh("hh", res.hh)}


TSNE_PREFIX = dict(backend="sparse", n_iter=8, grid_size=32, knn=10,
                  grid_max=64, adaptive_interval=4, exaggeration_iters=5,
                  momentum_switch=5)          # tests/test_mesh_embed.py:256
TSNE_LONG = dict(backend="sparse", n_iter=150, grid_size=32, knn=10,
                 exaggeration_iters=40, momentum_switch=40,
                 learning_rate=20.0)           # tests/test_mesh_embed.py:275
ANN_DRAWN = dict(probes=1, bucket=32)           # descent does the work


def _sparse_grad_block(x, sp, y, world, rank, mesh, grid_size=32,
                       exag=12.0):
    """This rank's sharded gradient of ``sp`` at ``y`` (cut on the
    device), gathered whole: (grad (n_padded, 2), KL)."""
    import torch
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import tsne
    n = x.shape[0]
    axis = mesh_mod.mesh_axis(mesh)
    blk = tsne.sparse_p_block(sp, n, world, rank)
    rows_per, n_pad = mesh_mod.row_block(n, world)
    yp = torch.cat([y, y.new_zeros((n_pad - n, 2))])
    y_blk = yp[blk.row_offset:blk.row_offset + rows_per].clone()
    y_full = mesh_mod.all_gather(y_blk, mesh, axis)
    g, kl = tsne.sparse_grad_shard(y_blk, blk, y_full, exag, grid_size,
                                   mesh, axis, n)
    return mesh_mod.all_gather(g, mesh, axis), kl


def tsne(rank: int, world: int, init: str, inp: dict) -> dict:
    """The sparse tSNE and the approximate kNN on a 1-D mesh of CPU
    ranks: the sharded gradient of the fed P, the optimizer from fed
    inits, the ANN graph, and the pipeline with ``embed_mesh``."""
    import torch
    from repro_torch import carry
    from repro_torch.core import ann, neighbors, pipeline
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import tsne as tsne_mod
    mesh = mesh_mod.init_mesh(rank, world, init, (world,),
                              (mesh_mod.EMBED_AXIS,),
                              backend=mesh_mod.pick_backend("cpu"))
    x, w = torch.from_numpy(inp["blob_x"]), torch.from_numpy(inp["blob_w"])
    sp = tsne_mod.SparseP(*[torch.from_numpy(inp[f"sp_{f}"])
                            for f in tsne_mod.SparseP._fields])
    g, kl = _sparse_grad_block(x, sp, torch.from_numpy(inp["grad_y"]),
                               world, rank, mesh)
    out = {"grad": g.numpy(), "grad_kl": kl.numpy()}
    for gi in (0.0, 0.5):
        cfg = tsne_mod.TsneConfig(grid_interval=gi, **TSNE_PREFIX)
        y, k = tsne_mod.run_tsne(x, cfg, weights=w, mesh=mesh,
                                 init=torch.from_numpy(inp["prefix_init"]))
        out[f"prefix_{gi}"], out[f"prefix_kl_{gi}"] = y.numpy(), k.numpy()
    _, k = tsne_mod.run_tsne(x, tsne_mod.TsneConfig(**TSNE_LONG), weights=w,
                             mesh=mesh,
                             init=torch.from_numpy(inp["long_init"]))
    out["long_kl"] = k.numpy()
    for n in (203, 100):
        i, d = neighbors.knn_graph(x[:n], 10, method="ann", mesh=mesh)
        out[f"ann_idx_{n}"], out[f"ann_dist_{n}"] = i.numpy(), d.numpy()
    xa = torch.from_numpy(inp["ann_x"])
    draws = carry.ann_draws_from_numpy(inp["ann_rot"], inp["ann_off"],
                                       inp["ann_slots"])
    i, d = ann.ann_knn_graph(xa, int(inp["ann_k"]),
                             ann.AnnConfig(**ANN_DRAWN), mesh=mesh,
                             draws=draws)
    out["drawn_idx"], out["drawn_dist"] = i.numpy(), d.numpy()
    cfg = pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=64,
                             embedder="tsne", embed_backend="sparse",
                             embed_mesh=mesh)
    r = pipeline.run(cfg, inp["pipe_pts"], device="cpu",
                     tsne_cfg=tsne_mod.TsneConfig(
                         n_iter=8, learning_rate=10.0))
    out["pipe_embedding"] = r.embedding.numpy()
    out["pipe_kl"] = r.kl_trace.numpy()
    return out


def card_tsne(rank: int, world: int, init: str, inp: dict) -> dict:
    """The ANN graph on a 1-D mesh of ranks on the card (gloo ranks
    sharing cuda:0 when the inputs say ``shared``, else one nccl rank per
    card), then the sharded gradient of the P built from it.  Returns
    the graph, the gathered gradient, the KL and the launches."""
    import torch
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import neighbors
    from repro_torch.core import tsne as tsne_mod
    from repro_torch.kernels import LAUNCHES
    shared = bool(inp["shared"])
    dev = torch.device("cuda", 0 if shared else rank)
    torch.cuda.set_device(dev)
    mesh = mesh_mod.init_mesh(
        rank, world, init, (world,), (mesh_mod.EMBED_AXIS,),
        backend=mesh_mod.pick_backend(dev, world if shared else 1))
    x = torch.from_numpy(inp["x"]).to(dev)
    w = torch.from_numpy(inp["w"]).to(dev)
    LAUNCHES.clear()
    idx, dist = neighbors.knn_graph(x, int(inp["k"]), method="ann",
                                    mesh=mesh)
    k4 = LAUNCHES["knn_dist_tiles"]
    sp = tsne_mod.sparse_p_from_knn(idx, dist, float(inp["perplexity"]),
                                    weights=w)
    LAUNCHES.clear()
    g, kl = _sparse_grad_block(x, sp, torch.from_numpy(inp["y"]).to(dev),
                               world, rank, mesh,
                               grid_size=int(inp["grid"]))
    torch.cuda.synchronize()
    return {"idx": idx.cpu().numpy(), "dist": dist.cpu().numpy(),
            "grad": g.cpu().numpy(), "kl": kl.cpu().numpy(),
            "k4": np.int64(k4),
            **{op: np.int64(LAUNCHES[op]) for op in
               ("segment_reduce", "cic_splat", "cic_gather")}}


def main(argv) -> int:
    job, rank, world, init, inputs, out = argv
    rank, world, out = int(rank), int(world), Path(out)
    try:
        inp = dict(np.load(inputs))
        res = {"geo": geo, "card": card, "tsne": tsne,
               "card_tsne": card_tsne}[job](rank, world, init, inp)
        np.savez(out / f"rank{rank}.npz", **res)
    except Exception:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        return 1
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
