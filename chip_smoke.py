#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases, each failing the run (non-zero exit) if it fails:

1. build   — every CUDA kernel of the port, from the sources in this
             checkout (one nvcc per source, all started together);
2. check   — each kernel once against its plain PyTorch version on a small
             CSR, before anything large runs;
3. main    — after one small warm-up run (which loads the CUDA modules
             the path uses; launch counts are reset after it),
             ``pipeline.run`` at the paper's cancer configuration
             (``configs.sns_paper.CANCER``, exact kNN) on
             ``gaussian_mixture(26_000_000, dims=8)``, the paper's 26M
             post-cut pixels: per-stage times, #HH, #reps, coverage; asserts
             no NaN, K1's launch count == 2·n_epochs, and blob separation of
             the reps labelled by their nearest mixture centre;
4. kernels — K1 at the main path's own shapes (the src- and dst-side
             bounds of its edge layout): bit-exact on integer payloads,
             |kernel − plain_f64| <= 1e-5·Σ|v|_row + 1e-6 on random ones,
             and its time beside the plain version's, the library call's
             and the memory bound;
5. profile — torch.profiler over a few epochs of the main path's own
             UMAP epoch: device time by kernel and the device's busy share;
6. parity  — the sketch stage at 2^20 points on the card, bit-identical to
             the port's CPU run given the same hash parameters.

Prints the nvidia-smi name/power-limit line, then one
``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
N_POINTS = 26_000_000               # paper §IV: 26M cancer pixels post cut
PARITY_POINTS = 1 << 20
WARMUP_POINTS = 1 << 18
PROFILE_EPOCHS = 5


def log(*args):
    print(*args, flush=True)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events).
    Where the host takes longer to issue a call than the card to run it,
    this is the host's issue rate, not the kernels' time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof):
    """(total device µs, [(µs, count, name)]) over the CUDA events of a
    profile: the kernels themselves, not the host ops that launched them."""
    from torch.autograd import DeviceType
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    evs.sort(key=lambda ev: -ev.self_device_time_total)
    return (sum(ev.self_device_time_total for ev in evs),
            [(ev.self_device_time_total, ev.count, ev.key) for ev in evs])


def device_ms(fn, iters: int) -> float:
    """Mean device time per call (ms): the summed duration of the CUDA
    kernels ``iters`` calls run, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_kernels(prof)[0] / iters / 1e3


def check_segment_reduce(vals_int, vals_rand, bounds):
    """K1 against its plain version on the card: bit-exact on integer
    payloads, within 1e-5·Σ|v|_row + 1e-6 of the float64 plain version
    on random ones.  Returns the max abs error on the random payload."""
    import torch
    from repro_torch.kernels import segment_reduce as segred
    got = segred.segment_reduce_cuda(vals_int, bounds)
    want = segred.segment_reduce_torch(vals_int, bounds)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("segment_reduce: not bit-exact on integer "
                             f"payloads (max diff "
                             f"{(got - want).abs().max().item()})")
    got = segred.segment_reduce_cuda(vals_rand, bounds).double()
    want = segred.segment_reduce_torch(vals_rand.double(), bounds)
    scale = segred.segment_reduce_torch(vals_rand.double().abs(), bounds)
    err = (got - want).abs()
    if not bool((err <= 1e-5 * scale + 1e-6).all()):
        raise AssertionError(f"segment_reduce: random payload off by "
                             f"{err.max().item()}")
    return err.max().item()


def phase_check(device):
    """Each kernel once, small, before the main path."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(0)
    sizes = torch.randint(0, 40, (1000,), generator=g)
    sizes[::97] = 0
    sizes[5] = 3000                                  # one hub row
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64),
                        sizes.cumsum(0)]).to(torch.int32)
    e = int(bounds[-1])
    vi = torch.randint(-1000, 1000, (e, 2), generator=g).float()
    vr = torch.randn((e, 2), generator=g)
    err = check_segment_reduce(vi.to(device), vr.to(device), bounds.to(device))
    err1 = check_segment_reduce(vi[:, 0].contiguous().to(device),
                                vr[:, 0].contiguous().to(device),
                                bounds.to(device))
    log(f"[check] segment_reduce small CSR (N=1000, E={e}): bit-exact on "
        f"integers; random max_abs_err {err:.3e} (2-D), {err1:.3e} (1-D)")


def blob_separation(reps, emb, centers):
    """tests/test_umap.py's contract on the reps, labelled by their
    nearest mixture centre: min inter-blob distance > 1.5 × max intra."""
    import torch
    labels = torch.cdist(reps.double(), centers.double()).argmin(1)
    intra, means = [], []
    for a in range(centers.shape[0]):
        ya = emb[labels == a].double()
        if ya.shape[0] == 0:
            continue
        means.append(ya.mean(0))
        intra.append((ya - ya.mean(0)).norm(dim=1).mean().item())
    m = torch.stack(means)
    d = torch.cdist(m, m)
    inter = d[torch.triu(torch.ones_like(d, dtype=torch.bool), 1)]
    return inter.min().item(), max(intra), len(means)


def phase_main(device, n_points):
    import numpy as np
    import torch
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture
    from repro_torch.kernels import LAUNCHES

    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    spec = MixtureSpec(dims=8)
    t0 = time.perf_counter()
    warm, _ = gaussian_mixture(WARMUP_POINTS, spec, seed=2)
    pipeline.run(dataclasses.replace(cfg, top_k=2000), warm, device=device)
    torch.cuda.synchronize()
    log(f"[main] warm-up run ({WARMUP_POINTS} points, top_k 2000) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pts_np, _ = gaussian_mixture(n_points, spec, seed=0)
    pts = torch.from_numpy(pts_np).to(device)
    del pts_np
    torch.cuda.synchronize()
    log(f"[main] data: {n_points} x 8 float32 points on the card "
        f"({pts.numel() * 4 / 1e6:.0f} MB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.run(cfg, pts, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_hh = int(res.hh.mask.sum())
    n_reps = res.embedding.shape[0]
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    log(f"[main] pipeline.run {wall:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()))
    log(f"[main] #HH {n_hh}, #reps {n_reps}, coverage {res.coverage:.4f}, "
        f"hh_error_bound {res.hh_error_bound}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    emb = res.embedding
    if emb.shape != (n_reps, cfg.embed_dims) or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError(f"embedding not finite / wrong shape "
                             f"{tuple(emb.shape)}")
    if launches.get("segment_reduce", 0) != 2 * n_epochs:
        raise AssertionError(f"segment_reduce launched "
                             f"{launches.get('segment_reduce', 0)} times, "
                             f"expected 2 x {n_epochs}")
    reps = res.reps.points[res.reps.mask]
    centers = torch.as_tensor(np.asarray(spec.centers(0), np.float32),
                              device=device)
    inter, intra, n_blobs = blob_separation(reps, emb, centers)
    log(f"[main] blob separation over {n_blobs} blobs: min inter "
        f"{inter:.3f} vs max intra {intra:.3f}")
    if not (n_blobs == spec.n_clusters and inter > 1.5 * intra):
        raise AssertionError("blobs do not separate")
    return cfg, res, launches, wall


def phase_kernels(cfg, res, launches):
    """K1 at the main path's shapes; returns its kernels-line entry."""
    import torch
    from repro_torch.core import coo, neighbors, pipeline, umap
    from repro_torch.kernels import segment_reduce as segred

    ecfg = pipeline.resolve_embed_cfg(cfg)
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = neighbors.knn_graph(x, ecfg.n_neighbors, block=ecfg.block,
                                    method=ecfg.knn_method)
    torch.cuda.synchronize()
    timings["knn"] = time.perf_counter() - t0
    edges, memb = umap.fuzzy_simplicial_set(idx, dist, weights=w)
    torch.cuda.synchronize()
    timings["fuzzy"] = time.perf_counter() - t0 - timings["knn"]
    n = x.shape[0]
    lay, order = coo.edge_layout(edges[:, 0], edges[:, 1], n)
    torch.cuda.synchronize()
    log(f"[kernels] embed breakdown (s): knn {timings['knn']:.3f}, fuzzy "
        f"{timings['fuzzy']:.3f} (optimizer = embed minus these)")
    e, d = lay.src.shape[0], cfg.embed_dims
    dst_sizes = (lay.dst_bounds[1:] - lay.dst_bounds[:-1]).float()
    log(f"[kernels] layout: N {n}, E {e}, D {d}; dst rows: max "
        f"{int(dst_sizes.max())}, mean {dst_sizes.mean().item():.1f}, "
        f"empty {int((dst_sizes == 0).sum())}")
    g = torch.Generator(device=x.device).manual_seed(1)
    sides = {}
    for side, bounds in (("src", lay.src_bounds), ("dst", lay.dst_bounds)):
        vi = torch.randint(-1000, 1000, (e, d), generator=g,
                           device=x.device).float()
        vr = torch.randn((e, d), generator=g, device=x.device)
        err = check_segment_reduce(vi, vr, bounds)
        offsets = bounds.to(torch.int64)
        fns = {"ms": lambda: segred.segment_reduce_cuda(vr, bounds),
               "plain_ms": lambda: segred.segment_reduce_torch(vr, bounds),
               "library_ms": lambda: torch.segment_reduce(
                   vr, "sum", offsets=offsets)}
        nbytes = e * d * 4 + (n + 1) * 4 + n * d * 4
        row = dict(bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bytes=nbytes,
                   max_abs_err=err)
        for key, fn in fns.items():
            row[key] = device_ms(fn, 100)
            row["call_" + key] = time_cuda(fn, 200)
        sides[side] = row
        log(f"[kernels] segment_reduce {side} (device us per call | "
            f"back-to-back us per call): kernel {row['ms'] * 1e3:.2f} | "
            f"{row['call_ms'] * 1e3:.2f}, plain {row['plain_ms'] * 1e3:.2f}"
            f" | {row['call_plain_ms'] * 1e3:.2f}, torch.segment_reduce "
            f"{row['library_ms'] * 1e3:.2f} | "
            f"{row['call_library_ms'] * 1e3:.2f}; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB), "
            f"max_abs_err {err:.3e}")

    def mean(key):
        return sum(s[key] for s in sides.values()) / len(sides)
    memb_n = (memb / memb.max().clamp(min=1e-12))[order]
    phase_profile(res.embedding.clone(), lay, memb_n, ecfg)
    return {"name": "segment_reduce", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_reduce.py:49",
            "launches": launches.get("segment_reduce", 0),
            "max_abs_err": max(s["max_abs_err"] for s in sides.values()),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": "bytes",
            "library_ms": mean("library_ms"),
            "call_ms": mean("call_ms"),
            "shapes": {"n": n, "e": e, "d": d},
            "per_call": sides}


def phase_profile(y, lay, memb_n, ecfg):
    """torch.profiler over PROFILE_EPOCHS of the main path's UMAP epoch
    (its own layout and memberships): device time by kernel, and the
    device's busy share of the wall time (the profiler's own overhead
    inflates the wall time, so the busy share is a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import umap
    a, b = umap.fit_ab(ecfg.spread, ecfg.min_dist)
    n, e = y.shape[0], lay.src.shape[0]
    g = torch.Generator(device=y.device).manual_seed(2)

    def epochs():
        nonlocal y
        for _ in range(PROFILE_EPOCHS):
            neg = torch.randint(0, n, (e, ecfg.neg_rate), generator=g,
                                device=y.device)
            y = y + 0.01 * umap.epoch_delta(y, lay, memb_n, neg, a, b)
    epochs()                                              # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epochs()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / PROFILE_EPOCHS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epochs()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernels = device_kernels(prof)
    log(f"[profile] UMAP epoch (N {n}, E {e}): {plain_wall * 1e3:.3f} ms "
        f"host wall per epoch unprofiled; profiled {PROFILE_EPOCHS} epochs "
        f"{wall * 1e3:.2f} ms wall, device busy {busy_us / 1e3:.2f} ms "
        f"({busy_us / 1e6 / wall:.1%} of profiled wall, "
        f"{busy_us / 1e6 / PROFILE_EPOCHS / plain_wall:.1%} of unprofiled); "
        f"{sum(c for _, c, _ in kernels) // PROFILE_EPOCHS} kernels/epoch")
    for us, count, name in kernels[:12]:
        log(f"[profile]   {us / PROFILE_EPOCHS:9.1f} us/epoch  "
            f"x{count // PROFILE_EPOCHS:<3d} {name[:90]}")


def phase_parity(cfg, device):
    """Sketch stage on the card vs the port's CPU run, same hash params."""
    import torch
    from repro_torch.core import hashing, pipeline
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture

    pts, _ = gaussian_mixture(PARITY_POINTS, MixtureSpec(dims=8), seed=1)
    hp = hashing.make_params(torch.Generator().manual_seed(cfg.seed),
                             cfg.rows)
    t0 = time.perf_counter()
    g_gpu, hh_gpu = pipeline.sketch_stage(cfg, pts, device=device,
                                          hash_params=hp)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_cpu, hh_cpu = pipeline.sketch_stage(cfg, pts, device="cpu",
                                          hash_params=hp)
    t2 = time.perf_counter()
    same = g_gpu == g_cpu and all(
        torch.equal(a.cpu(), b) for a, b in zip(hh_gpu, hh_cpu))
    log(f"[parity] sketch stage at {PARITY_POINTS} points: card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s, #HH "
        f"{int(hh_cpu.mask.sum())}, bit-identical: {same}")
    if not same:
        raise AssertionError("card and CPU heavy hitters differ")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=N_POINTS,
                    help="points in the main path's input (default: the "
                         "paper's 26M)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # fp32 products stay fp32 (PyTorch's default, stated here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        log(f"[build] {name}:\n{rep.strip()}")
    phase_check(device)
    cfg, res, launches, _ = phase_main(device, args.points)
    entry = phase_kernels(cfg, res, launches)
    phase_parity(cfg, device)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
