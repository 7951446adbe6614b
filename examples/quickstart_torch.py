"""Quickstart on the PyTorch port: Sketch-and-Scale on a synthetic
clustered point cloud.

    PYTHONPATH=src python examples/quickstart_torch.py [--n 200000]
        [--tsne] [--device cpu|cuda] [--ranks R] [--out emb.csv]

The twin of examples/quickstart.py on ``repro_torch``: quantize → Count
Sketch → heavy hitters → weighted jittered representatives → UMAP (or
tSNE).  Prints coverage and HH statistics; ``--out`` writes the 2-D
embedding as CSV.  The port runs on the card unless ``--device cpu``.

``--ranks R`` runs the mesh tier instead: R processes, one a rank, as a
``("pod", "data")`` DeviceMesh, each sketching only its own row block of
the points (the paper's sites); the tables merge by one all-reduce and
every rank embeds the same heavy hitters, row-block-sharded over the
ranks: UMAP, or with ``--tsne`` the sparse tSNE (the backend a mesh
shards) with its kNN graph.  The backend follows ``mesh.pick_backend``:
gloo for CPU ranks or ranks sharing one card, nccl for one card a rank.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import mesh as mesh_mod                # noqa: E402
from repro_torch.core import pipeline                         # noqa: E402
from repro_torch.core.tsne import TsneConfig                  # noqa: E402
from repro_torch.core.umap import UmapConfig                  # noqa: E402
from repro_torch.data.synthetic import (MixtureSpec,          # noqa: E402
                                        gaussian_mixture)


def _config(args) -> pipeline.SnsConfig:
    return pipeline.SnsConfig(
        bins=16, rows=8, log2_cols=14, top_k=args.top_k,
        embedder="tsne" if args.tsne else "umap", max_replicas=4,
        embed_backend=args.embed_backend, embed_knn_method=args.knn_method)


def _points(args):
    spec = MixtureSpec(dims=6, n_clusters=args.clusters, cluster_std=0.015,
                       background_frac=0.3)
    pts, _ = gaussian_mixture(args.n, spec, seed=0)
    return spec, pts


def _report(cfg, res, out=None):
    live = int(res.hh.mask.sum())
    print(f"[sketch] {cfg.rows}x{1 << cfg.log2_cols} Count Sketch")
    print(f"[hh] {live} heavy hitters; top cell holds "
          f"{float(res.hh.count[0]):.0f} points; coverage of stream = "
          f"{res.coverage:.1%}")
    print(f"[embed] {res.embedding.shape[0]} representatives -> "
          f"{res.embedding.shape[1]}-D via {cfg.embedder}; stages (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()))
    if out:
        emb = np.concatenate([res.embedding.cpu().numpy(),
                              res.rep_weight.cpu().numpy()[:, None]], 1)
        np.savetxt(out, emb, delimiter=",", header="x,y,weight")
        print(f"[out] {out}")


def _rank(rank: int, args, init: str):
    """One rank of ``--ranks``: its row block, the mesh run, a report."""
    import torch
    world = args.ranks
    shared = args.device == "cpu" or torch.cuda.device_count() < world
    dev = torch.device("cpu") if args.device == "cpu" else \
        torch.device("cuda", 0 if shared else rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:                  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend = mesh_mod.pick_backend(dev, world if shared else 1)
    shape = (2, world // 2) if world % 2 == 0 else (1, world)
    mesh = mesh_mod.init_mesh(rank, world, init, shape, ("pod", "data"),
                              backend=backend)
    try:
        _, pts = _points(args)
        axes = ("data", "pod")
        rows, _ = mesh_mod.row_block(len(pts), world)
        i = mesh_mod.linear_index(mesh, axes)
        cfg = _config(args)
        if cfg.embedder == "tsne":        # a mesh shards the sparse backend
            cfg = dataclasses.replace(cfg, embed_backend="sparse")
        cfg = dataclasses.replace(cfg, embed_mesh=mesh_mod.make_embed_mesh())
        res = pipeline.run(cfg, pts[i * rows:(i + 1) * rows], mesh=mesh,
                           data_axes=axes, device=dev,
                           tsne_cfg=TsneConfig(n_iter=250),
                           umap_cfg=UmapConfig(n_neighbors=10, n_epochs=200))
        if rank == 0:
            print(f"[mesh] {world} {backend} ranks as {shape} "
                  f"('pod', 'data'); rank 0 sketched rows "
                  f"[{i * rows}, {(i + 1) * rows})")
            _report(cfg, res, args.out)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--tsne", action="store_true")
    ap.add_argument("--embed-backend", default="dense",
                    choices=("dense", "tiled", "pallas", "sparse"))
    ap.add_argument("--knn-method", default="auto",
                    choices=("auto", "exact", "ann"))
    ap.add_argument("--top-k", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=0,
                    help="run the mesh tier on this many rank processes")
    ap.add_argument("--out", default=None, help="write the embedding here")
    args = ap.parse_args()

    if args.ranks:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, args=(args, f"file://{tmp}/rdv"),
                               nprocs=args.ranks, start_method="spawn")
        return
    spec, pts = _points(args)
    print(f"[data] {args.n} points, {args.clusters} clusters + 30% "
          f"uniform background, D={spec.dims}")
    cfg = _config(args)
    res = pipeline.run(cfg, pts, device=args.device,
                       tsne_cfg=TsneConfig(n_iter=250),
                       umap_cfg=UmapConfig(n_neighbors=10, n_epochs=200))
    _report(cfg, res, args.out)


if __name__ == "__main__":
    main()
