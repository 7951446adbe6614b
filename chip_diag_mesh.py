#!/usr/bin/env python3
"""Where an iteration of path M step (d)'s sharded sparse tSNE goes, on
the card.

    python3 chip_diag_mesh.py [--layouts nccl1,gloo2,gloo4,nccl4]
                              [--iters 20] [--points path-a|random]

chip_smoke.py's step (d) runs ``run_tsne(mesh=)`` at path A's widths:
10⁶ representatives, k 90 (E ≈ 1.8·10⁸ edges), G up to 1024.  This
script makes chip_smoke's 26M points, takes path A's 10⁶ representatives
and weights from ``CANCER_1M``'s sketch and replica stages on one
device, and for each layout spawns its ranks (one process a rank: gloo
ranks share cuda:0, nccl ranks own a card).  Every rank builds the same
sparse P on its card (the approximate kNN graph, replicated, as (d)
does), cuts its row block (``tsne.sparse_p_block``) and times the loop
body of ``tsne._run_tsne_sparse_mesh`` (one all-gather of y,
``sparse_grad_shard``, ``_momentum_update_shard``) at G 1024,
exaggeration 1, from a random map of span ~900.  ``--points random``
takes 10⁶ points of the mixture with random weights instead, whose row
blocks hold nearly equal edge counts:

* the block: its real edges and the padding up to the widest block;
* ``loop``: ms an iteration, ``--iters`` iterations, one synchronize at
  the end; ``loop_pad_row``: the same with the block's bounds as the
  host layout (``tsne.shard_sparse_p``) has them, the padding in the
  block's last row; K1 alone on the block's payload under both bounds
  (CUDA events);
* ``split``: the same with every collective bracketed by synchronizes:
  ms an iteration inside the collectives (waiting for the other ranks
  included) and outside them (this rank's own card work and launches);
* a torch.profiler trace of 5 iterations: device ms an iteration by op
  (the collectives' kernels and copies included) and host ms by op;
* rank 0 alone, the others waiting: the single-device ``sparse_grad``
  and ``_momentum_update`` of the whole P on the same card;
* the entry point, ``run_tsne(mesh=)`` at path A's settings (adaptive G
  from 256 up to 1024) for 50 iterations: its seconds, split into the
  kNN + P build and the loop (ms an iteration), so that a per-iteration
  figure taken as the embed stage less its other parts can be checked.

Layouts: nccl1 (1 rank), gloo2 and gloo4 (2 and 4 ranks sharing cuda:0),
nccl4 (4 ranks, 4 cards; only when 4 are visible).  Default: every
layout the visible cards allow.  Needs the repository beside it; about
a minute a layout after ~20 s of set-up.  Prints the nvidia-smi
name/power-limit line.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GRID = 1024
RANDOM_POINTS = 1_000_000
PROFILE_ITERS = 5
E2E_ITERS = 50
TIMEOUT_S = 600

LAYOUTS = {"nccl1": (1, "nccl", False), "gloo2": (2, "gloo", True),
           "gloo4": (4, "gloo", True), "nccl4": (4, "nccl", False)}


def _rank(rank, world, backend, shared, tmp, iters, queue):
    import traceback
    try:
        queue.put((rank, "ok", _rank_body(rank, world, backend, shared,
                                          Path(tmp), iters)))
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _top(rows, key, n=12):
    return [(name, round(v, 3), round(c, 1)) for name, v, c in
            sorted(rows, key=lambda r: -r[key])[:n]]


def _rank_body(rank, world, backend, shared, tmp, iters):
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import time_cuda
    from repro_torch.configs.sns_paper import CANCER_1M
    from repro_torch.core import coo
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import pipeline, tsne

    dev = torch.device("cuda", 0 if shared else rank)
    if shared:
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    torch.cuda.set_device(dev)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh_mod.init_mesh(rank, world, f"file://{tmp / 'rendezvous'}",
                       (1, world), ("pod", "data"), backend=backend)
    emesh = mesh_mod.make_embed_mesh()
    axis = mesh_mod.EMBED_AXIS
    sys.path.insert(0, str(ROOT))
    data = np.load(tmp.parent / "reps.npz")
    x = torch.from_numpy(data["x"]).to(dev)
    w = torch.from_numpy(data["w"]).to(dev)
    y_all = torch.from_numpy(data["y"]).to(dev)
    n = x.shape[0]
    cfg = tsne.TsneConfig(learning_rate=n / 12)
    sp = tsne.build_sparse_p(x, cfg.perplexity, weights=w, method="ann")
    del x, w
    blk = tsne.sparse_p_block(sp, n, world, emesh.get_local_rank(axis))
    rows_per, n_pad = mesh_mod.row_block(n, world)
    live = tsne._live_rows(blk, n)
    lo = blk.row_offset
    y0 = torch.cat([y_all, y_all.new_zeros((n_pad - n, 2))])[
        lo:lo + rows_per].clone()
    real = int(blk.bounds[-1])
    # the host layout's bounds: the padding in the block's last row
    pad_row = blk._replace(bounds=torch.searchsorted(
        blk.src - lo, torch.arange(rows_per + 1, device=dev),
        out_int32=True))
    out = {"rank": rank, "E": int(sp.src.shape[0]),
           "Ep": int(blk.src.shape[0]), "real_edges": real,
           "pad": int(blk.src.shape[0]) - real, "rows_per": rows_per}

    def body(st, b):
        y_full = mesh_mod.all_gather(st.y, emesh, axis)
        grad, _ = tsne.sparse_grad_shard(st.y, b, y_full, 1.0, GRID,
                                         emesh, axis, n)
        return tsne._momentum_update_shard(st, grad, cfg.momentum_final,
                                           cfg, emesh, axis, live, n)

    def run(k, b=blk):
        st = tsne.TsneState(y0, torch.zeros_like(y0), torch.ones_like(y0))
        for _ in range(k):
            st = body(st, b)
        return st

    def timed(k, b=blk):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(k, b)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / k * 1e3

    run(3)                                    # cuFFT plans, NCCL setup
    out["loop_ms"] = timed(iters)
    out["loop_pad_row_ms"] = timed(iters, pad_row)
    vals = torch.randn((blk.src.shape[0], 2), device=dev) * (blk.val > 0)[
        :, None]
    for key, b in (("k1_ms", blk.bounds), ("k1_pad_row_ms", pad_row.bounds)):
        out[key] = time_cuda(lambda: coo.segment_reduce(vals, b), 20)
    del vals, pad_row

    # the same with every collective bracketed by synchronizes
    inside = [0.0]
    orig = {f: getattr(mesh_mod, f) for f in ("all_gather", "all_reduce")}

    def bracket(fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            inside[0] += time.perf_counter() - t0
            return res
        return wrapped
    for f, fn in orig.items():
        setattr(mesh_mod, f, bracket(fn))
    try:
        out["split_ms"] = timed(iters)
    finally:
        for f, fn in orig.items():
            setattr(mesh_mod, f, fn)
    out["collective_ms"] = inside[0] / iters * 1e3
    out["outside_ms"] = out["split_ms"] - out["collective_ms"]

    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(PROFILE_ITERS)
        torch.cuda.synchronize(dev)
    dev_rows, cpu_rows = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            dev_rows.append((e.key[:90], dev_us / PROFILE_ITERS / 1e3,
                             e.count / PROFILE_ITERS))
        if e.self_cpu_time_total > 0:
            cpu_rows.append((e.key[:90], e.self_cpu_time_total
                             / PROFILE_ITERS / 1e3, e.count / PROFILE_ITERS))
    out["device_ms"] = sum(r[1] for r in dev_rows)
    out["comm_device_ms"] = sum(
        r[1] for r in dev_rows if "nccl" in r[0].lower()
        or "memcpy" in r[0].lower())
    out["host_ms"] = sum(r[1] for r in cpu_rows)
    out["top_device"] = _top(dev_rows, 1)
    out["top_host"] = _top(cpu_rows, 1, 8)

    # rank 0 alone: the whole P on one device, the same card
    dist.barrier()
    if rank == 0:
        def single(k):
            st = tsne.TsneState(y_all, torch.zeros_like(y_all),
                                torch.ones_like(y_all))
            for _ in range(k):
                grad, _ = tsne.sparse_grad(st.y, sp, 1.0, GRID)
                st = tsne._momentum_update(st, grad, cfg.momentum_final, cfg)
            return st
        single(3)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        single(iters)
        torch.cuda.synchronize(dev)
        out["single_ms"] = (time.perf_counter() - t0) / iters * 1e3
    dist.barrier()
    del sp, blk

    # the entry point itself: run_tsne(mesh=) at path A's settings for
    # E2E_ITERS iterations, its kNN + P build and its loop timed apart
    ecfg = pipeline.resolve_embed_cfg(CANCER_1M, tsne_cfg=dataclasses.replace(
        cfg, n_iter=E2E_ITERS))
    secs = {}
    orig_opt, orig_p = tsne._optimize, tsne.build_sparse_p

    def timer(key, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            secs[key] = time.perf_counter() - t0
            return res
        return wrapped
    tsne._optimize = timer("loop", orig_opt)
    tsne.build_sparse_p = timer("build", orig_p)
    try:
        x = torch.from_numpy(data["x"]).to(dev)
        w = torch.from_numpy(data["w"]).to(dev)
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tsne.run_tsne(x, ecfg, weights=w, mesh=emesh)
        torch.cuda.synchronize(dev)
        secs["total"] = time.perf_counter() - t0
    finally:
        tsne._optimize, tsne.build_sparse_p = orig_opt, orig_p
    out["e2e_s"] = secs
    out["e2e_loop_ms"] = secs["loop"] / E2E_ITERS * 1e3
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def path_a_reps(pts):
    """Path A's representatives and weights (host arrays): ``CANCER_1M``'s
    sketch stage on ``pts`` and the replica step of its embed stage."""
    import torch
    from repro_torch.configs.sns_paper import CANCER_1M as cfg
    from repro_torch.core import pipeline, prng, replicas
    grid, hh = pipeline.sketch_stage(cfg, pts, device=pts.device)
    krep = prng.split(prng.key(cfg.seed + 1, device=pts.device))[0]
    reps = replicas.make_representatives(
        grid, hh, scheme=cfg.replica_scheme, max_replicas=cfg.max_replicas,
        jitter_frac=cfg.jitter_frac, key=krep)
    x, w, _ = replicas.compact(reps)
    return x.cpu().numpy(), w.to(torch.float32).cpu().numpy()


def run_layout(ctx, name, tmp, iters):
    import queue as queue_mod
    world, backend, shared = LAYOUTS[name]
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, backend, shared,
                                             str(tmp), iters, q))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, errors = {}, []
    deadline = time.perf_counter() + TIMEOUT_S
    try:
        while len(reports) + len(errors) < world and not errors:
            try:
                rank, status, body = q.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                errors.append(f"timed out after {TIMEOUT_S} s")
                break
            if status == "ok":
                reports[rank] = body
            else:
                errors.append(f"rank {rank}:\n{body}")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return [reports[r] for r in sorted(reports)], errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="",
                    help="comma-separated layouts (default: every one the "
                         "visible cards allow)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--points", choices=("path-a", "random"),
                    default="path-a",
                    help="path A's reps, or 10⁶ points of the mixture "
                         "with random weights 1-49 (blocks of nearly "
                         "equal edge counts)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("chip_diag_mesh: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import N_POINTS, log, make_points, nvidia_smi_line
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture
    from repro_torch.kernels import _build
    _build.build_all()
    names = [s for s in args.layouts.split(",") if s] or [
        name for name, (world, backend, _) in LAYOUTS.items()
        if backend == "gloo" or torch.cuda.device_count() >= world]
    rng = np.random.default_rng(1)
    if args.points == "random":
        x, _ = gaussian_mixture(RANDOM_POINTS, MixtureSpec(dims=8), seed=0)
        w = rng.integers(1, 50, RANDOM_POINTS).astype(np.float32)
    else:
        x, w = path_a_reps(make_points(torch.device("cuda"), N_POINTS)[0])
        torch.cuda.empty_cache()
    y = (100.0 * rng.normal(size=(x.shape[0], 2))).astype(np.float32)
    log(f"[diag-mesh] {args.points} points: {x.shape[0]}, weights "
        f"{float(w.min())}-{float(w.max())}")
    smi = nvidia_smi_line()
    failed = False
    with tempfile.TemporaryDirectory(prefix="sns-diag-mesh-") as root:
        np.savez(Path(root) / "reps.npz", x=x, w=w, y=y)
        ctx = mp.get_context("spawn")
        for name in names:
            tmp = Path(root) / name
            tmp.mkdir()
            t0 = time.perf_counter()
            reps, errors = run_layout(ctx, name, tmp, args.iters)
            log(f"[diag-mesh] {name}: {time.perf_counter() - t0:.1f} s; "
                f"{smi}")
            for r in reps:
                tops = {k: r.pop(k) for k in ("top_device", "top_host")}
                log(f"[diag-mesh] {name} {r}")
                if r["rank"] == 0:
                    for k, rows in tops.items():
                        for row in rows:
                            log(f"[diag-mesh] {name}   {k} {row}")
            for e in errors:
                failed = True
                log(f"[diag-mesh] {name} FAILED: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
