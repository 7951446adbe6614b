#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases, each failing the run (non-zero exit) if it fails:

1. build       — every CUDA kernel of the port, from the sources in this
                 checkout (one nvcc per source, all started together);
2. check       — each kernel against its plain PyTorch version before
                 anything large runs: K1 on a small CSR; K2/K3 at
                 N = 100 003 on G = 128 and 1024 with points on the edge
                 cells; K5a/K5b at N = 6000 padded to 6144;
3. main        — ``pipeline.run`` at the paper's cancer configuration
                 (``CANCER``, UMAP, exact kNN) on
                 ``gaussian_mixture(26_000_000, dims=8)``, the paper's 26M
                 post-cut pixels, after a small warm-up run: per-stage
                 times, #HH, #reps, coverage; asserts no NaN, K1's launch
                 count == 2·n_epochs and blob separation of the reps
                 labelled by their nearest mixture centre;
4. kernels     — K1 at the main path's shapes against the plain version,
                 the library call and the memory bound; a profile of the
                 UMAP epoch;
5. tsne-sparse — path S: ``CANCER_100K`` (sparse tSNE, exact kNN, G 128,
                 500 iterations) on the same 26M points: stage times with
                 embed split into kNN, P build and iterations, #HH, #reps,
                 E, peak memory, first/last KL, blob separation; asserts
                 K1 = K2 = K3 = 500 launches; then K1, K2, K3 at its shapes
                 and a profile of its iteration;
6. tsne-exact  — path E: the ``CANCER`` sketch with ``embedder="tsne"``,
                 ``embed_backend="pallas"`` (the fused exact gradient) on
                 the same points, the same prints; asserts K5a = K5b = 500
                 launches; then K5a, K5b at its shapes and a profile;
7. parity      — the sketch stage at 2^20 points on the card, bit-identical
                 to the port's CPU run given the same hash parameters.

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
H100_FP32_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
# special-function unit (exp, log, reciprocal) results: 16 per clock per SM
# (CUDA C Programming Guide, throughput table, compute capability 9.0) on
# 132 SMs at the 1.98 GHz boost clock the 67 TFLOP/s fp32 figure implies
H100_SFU_PER_S = 132 * 16 * 1.98e9
N_POINTS = 26_000_000               # paper §IV: 26M cancer pixels post cut
PARITY_POINTS = 1 << 20
WARMUP_POINTS = 1 << 18
PROFILE_EPOCHS = 5
PROFILE_ITERS = 10
CHECK_CIC_POINTS = 100_003          # not a multiple of any block
CHECK_TSNE_POINTS = 6000            # padded to 6144 at block 512


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


def timings(fns, iters: int) -> dict:
    """Device ms and back-to-back ms of each named call."""
    row = {}
    for key, fn in fns.items():
        if fn is None:
            row[key] = row["call_" + key] = None
            continue
        row[key] = device_ms(fn, iters)
        row["call_" + key] = time_cuda(fn, iters, warmup=2)
    return row


def us(ms) -> str:
    return "n/a" if ms is None else f"{ms * 1e3:.2f}"


def log_row(tag: str, row: dict, extra: str = "") -> None:
    log(f"[kernels] {tag} (device us per call | back-to-back us per call): "
        f"kernel {us(row['ms'])} | {us(row['call_ms'])}, plain "
        f"{us(row['plain_ms'])} | {us(row['call_plain_ms'])}, library "
        f"{us(row['library_ms'])} | {us(row['call_library_ms'])}; bound "
        f"{us(row['bound_ms'])} us ({row['bound_by']}); max_abs_err "
        f"{row['max_abs_err']:.3e}{extra}")


def op_bound_ms(nbytes: float, flops: float = 0.0, sfu: float = 0.0):
    """The least time for the work: the larger of the bytes over the
    memory rate and the fp32 and special-function operations over their
    peak rates.  Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(flops / H100_FP32_PER_S, sfu / H100_SFU_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_segment_reduce(vals_int, vals_rand, bounds):
    """K1 against its plain version on the card: bit-exact on integer
    payloads, within 1e-5·Σ|v|_row + 1e-6 of the float64 plain version
    on random ones.  Returns the max abs error on the random payload.
    The integer reference is the float64 plain version: its cumsum stays
    exact at any E, where a float32 cumsum of ±1000 payloads leaves the
    exact range 2^24 at tens of millions of edges (path S)."""
    import torch
    from repro_torch.kernels import segment_reduce as segred
    got = segred.segment_reduce_cuda(vals_int, bounds)
    want = segred.segment_reduce_torch(vals_int.double(), bounds).float()
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


def check_cic(i0, f, vals, fields):
    """K2 against the float64 plain version, per cell within
    1e-5·Σ|contributions| + 1e-6 (float atomics add in a schedule-
    dependent order); K3 bit-exact against the float32 plain version and
    deterministic.  Returns (K2 max abs err, K3 max abs err against the
    float64 plain version)."""
    import torch
    from repro_torch.kernels import cic
    g = fields.shape[-1]
    got = cic.cic_splat_cuda(i0, f, vals, g).double()
    want = cic.cic_splat_torch(i0, f.double(), vals.double(), g)
    scale = cic.cic_splat_torch(i0, f.double(), vals.double().abs(), g)
    err = (got - want).abs()
    if not bool((err <= 1e-5 * scale + 1e-6).all()):
        raise AssertionError(f"cic_splat: off by {err.max().item()} at G={g}")
    got = cic.cic_gather_cuda(fields, i0, f)
    if not (torch.equal(got, cic.cic_gather_torch(fields, i0, f))
            and torch.equal(got, cic.cic_gather_cuda(fields, i0, f))):
        raise AssertionError(f"cic_gather: not bit-exact against the plain "
                             f"version at G={g}")
    err_g = (got.double() - cic.cic_gather_torch(
        fields.double(), i0, f.double())).abs().max().item()
    return err.max().item(), err_g


def check_tsne(xp, yp, sp, n, exag):
    """K5a/K5b against the float64 plain versions: Z and the KL rtol
    1e-5, forces within 1e-4 of the largest force; a second call
    identical.  Returns (max abs force err, Z rel err, KL rel err)."""
    import torch
    from repro_torch.kernels import tsne_forces as tf
    z = tf.tsne_z_cuda(yp, n)
    f, parts = tf.tsne_forces_cuda(xp, yp, sp, z, exag, n)
    z2 = tf.tsne_z_cuda(yp, n)
    f2, parts2 = tf.tsne_forces_cuda(xp, yp, sp, z2, exag, n)
    if not (torch.equal(z, z2) and torch.equal(f, f2)
            and torch.equal(parts, parts2)):
        raise AssertionError("tsne kernels: two calls differ")
    zw = tf.tsne_z_torch(yp.double(), n)
    fw, pw = tf.tsne_forces_torch(xp.double(), yp.double(), sp.double(), zw,
                                  exag, n)
    z_rel = abs(z.item() - zw.item()) / zw.item()
    f_err = (f.double() - fw).abs().max().item()
    kl, klw = tf.step_kl(parts, z, exag).item(), tf.step_kl(
        pw, zw, exag).item()
    kl_rel = abs(kl - klw) / max(1.0, abs(klw))
    if not (z_rel <= 1e-5 and f_err <= 1e-4 * fw.abs().max().item()
            and kl_rel <= 1e-5):
        raise AssertionError(f"tsne kernels: Z rel {z_rel:.3e}, force err "
                             f"{f_err:.3e} (max force "
                             f"{fw.abs().max().item():.3e}), KL rel "
                             f"{kl_rel:.3e}")
    return f_err, z_rel, kl_rel


def cic_inputs(device, n, g, seed):
    """Random embedding → cells (edge cells included), masses, fields."""
    import torch
    from repro_torch.core import tsne
    gen = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.randn((n, 2), generator=gen) * 20.0
    i0, f, _ = tsne._cic_weights(y, g)
    edge = torch.tensor([[0, 0], [0, g - 2], [g - 2, 0], [g - 2, g - 2]],
                        dtype=torch.int32)
    i0[:8] = edge[torch.arange(8) % 4]
    f[:8] = torch.tensor([[0.0, 0.0], [1.0, 1.0]])[torch.arange(8) % 2]
    vals = torch.randn((n, 3), generator=gen)
    fields = torch.randn((4, g, g), generator=gen)
    return [t.contiguous().to(device) for t in (i0, f, vals, fields)]


def tsne_inputs(device, n, block, seed):
    """Clustered 8-D points, a spread embedding, calibrated stats with
    random weights, all padded to ``block`` rows."""
    import torch
    from repro_torch.core import tsne
    from repro_torch.kernels import tsne_forces as tf
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cent = torch.rand((10, 8), generator=gen)
    x = cent[torch.randint(0, 10, (n,), generator=gen)] \
        + 0.02 * torch.randn((n, 8), generator=gen)
    y = torch.randn((n, 2), generator=gen) * 10.0
    w = torch.rand((n,), generator=gen) * 100 + 1
    x, y, w = x.to(device), y.to(device), w.to(device)
    st = tsne.calibrate_stats(x, 30.0, weights=w, block=block)
    return (tf.pad_rows(x, block), tf.pad_rows(y, block),
            tf.step_stats(st.beta, st.zp, st.shift, st.w, block))


def phase_check(device):
    """Each kernel against its plain version, before the main paths."""
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
    for grid in (128, 1024):
        e2, e3 = check_cic(*cic_inputs(device, CHECK_CIC_POINTS, grid, grid))
        log(f"[check] cic_splat / cic_gather at N={CHECK_CIC_POINTS}, "
            f"G={grid} (edge cells included): splat max_abs_err {e2:.3e} "
            f"(within 1e-5·Σ|contrib|+1e-6 per cell); gather bit-exact vs "
            f"the f32 plain version, {e3:.3e} vs f64")
    xp, yp, sp = tsne_inputs(device, CHECK_TSNE_POINTS, 512, 3)
    for exag in (12.0, 1.0):
        f_err, z_rel, kl_rel = check_tsne(xp, yp, sp, CHECK_TSNE_POINTS, exag)
        log(f"[check] tsne_z / tsne_forces at N={CHECK_TSNE_POINTS} padded "
            f"to {xp.shape[0]}, exag {exag}: force max_abs_err {f_err:.3e}, "
            f"Z rel {z_rel:.3e}, KL rel {kl_rel:.3e}; deterministic")


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


def make_points(device, n_points):
    """The main paths' input, made once: (points on the card, warm-up
    points on the host, the mixture spec)."""
    import torch
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture
    spec = MixtureSpec(dims=8)
    warm, _ = gaussian_mixture(WARMUP_POINTS, spec, seed=2)
    t0 = time.perf_counter()
    pts_np, _ = gaussian_mixture(n_points, spec, seed=0)
    pts = torch.from_numpy(pts_np).to(device)
    del pts_np
    torch.cuda.synchronize()
    log(f"[main] data: {n_points} x 8 float32 points on the card "
        f"({pts.numel() * 4 / 1e6:.0f} MB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    return pts, warm, spec


def drive(tag, cfg, pts, warm, spec, device, expect, **warm_kw):
    """One small warm-up run (which loads the CUDA modules the path uses),
    then ``pipeline.run(cfg, pts)`` with every launch count set to 0
    just before it and read just after.  Asserts finite output of the
    right shape, ``expect`` {op: launches}, finite KL and blob
    separation.  Returns (result, launches, wall seconds)."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    pipeline.run(dataclasses.replace(cfg, top_k=2000), warm, device=device,
                 **warm_kw)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up run ({WARMUP_POINTS} points, top_k 2000) "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.run(cfg, pts, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_reps = res.embedding.shape[0]
    log(f"[{tag}] pipeline.run {wall:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res.stage_seconds.items()))
    log(f"[{tag}] #HH {int(res.hh.mask.sum())}, #reps {n_reps}, coverage "
        f"{res.coverage:.4f}, hh_error_bound {res.hh_error_bound}, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB,"
        f" launches {launches}")
    emb = res.embedding
    if emb.shape != (n_reps, cfg.embed_dims) or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError(f"[{tag}] embedding not finite / wrong shape "
                             f"{tuple(emb.shape)}")
    for op, count in expect.items():
        if launches.get(op, 0) != count:
            raise AssertionError(f"[{tag}] {op} launched "
                                 f"{launches.get(op, 0)} times, expected "
                                 f"{count}")
    if res.kl_trace is not None:
        kl = res.kl_trace
        if not bool(torch.isfinite(kl).all()):
            raise AssertionError(f"[{tag}] KL trace not finite")
        log(f"[{tag}] KL first {kl[0].item():.4f}, last {kl[-1].item():.4f}"
            f" ({kl.shape[0]} iterations)")
    reps = res.reps.points[res.reps.mask]
    centers = torch.as_tensor(np.asarray(spec.centers(0), np.float32),
                              device=device)
    inter, intra, n_blobs = blob_separation(reps, emb, centers)
    log(f"[{tag}] blob separation over {n_blobs} blobs: min inter "
        f"{inter:.3f} vs max intra {intra:.3f}")
    if not (n_blobs == spec.n_clusters and inter > 1.5 * intra):
        raise AssertionError(f"[{tag}] blobs do not separate")
    return res, launches, wall


def phase_main(device, pts, warm, spec):
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline
    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    res, launches, _ = drive("main", cfg, pts, warm, spec, device,
                             {"segment_reduce": 2 * n_epochs})
    return cfg, res, launches


def phase_kernels(cfg, res, launches):
    """K1 at the main path's shapes; returns its kernels-line entry."""
    import torch
    from repro_torch.core import coo, neighbors, pipeline, umap
    from repro_torch.kernels import segment_reduce as segred

    ecfg = pipeline.resolve_embed_cfg(cfg)
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = neighbors.knn_graph(x, ecfg.n_neighbors, block=ecfg.block,
                                    method=ecfg.knn_method)
    torch.cuda.synchronize()
    times["knn"] = time.perf_counter() - t0
    edges, memb = umap.fuzzy_simplicial_set(idx, dist, weights=w)
    torch.cuda.synchronize()
    times["fuzzy"] = time.perf_counter() - t0 - times["knn"]
    n = x.shape[0]
    lay, order = coo.edge_layout(edges[:, 0], edges[:, 1], n)
    torch.cuda.synchronize()
    log(f"[kernels] embed breakdown (s): knn {times['knn']:.3f}, fuzzy "
        f"{times['fuzzy']:.3f} (optimizer = embed minus these)")
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
        sides[side] = segment_reduce_row(f"segment_reduce {side}", vi, vr,
                                         bounds)

    def mean(key):
        return sum(s[key] for s in sides.values()) / len(sides)
    memb_n = (memb / memb.max().clamp(min=1e-12))[order]
    phase_profile_umap(res.embedding.clone(), lay, memb_n, ecfg)
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


def segment_reduce_row(tag, vals_int, vals, bounds, iters=100):
    """K1 checked and timed on one CSR: kernel, plain version,
    ``torch.segment_reduce``, byte bound."""
    import torch
    from repro_torch.kernels import segment_reduce as segred
    err = check_segment_reduce(vals_int, vals, bounds)
    offsets = bounds.to(torch.int64)
    row = timings({"ms": lambda: segred.segment_reduce_cuda(vals, bounds),
                   "plain_ms": lambda: segred.segment_reduce_torch(vals,
                                                                   bounds),
                   "library_ms": lambda: torch.segment_reduce(
                       vals, "sum", offsets=offsets)}, iters)
    n, (e, d) = bounds.shape[0] - 1, vals.shape
    nbytes = e * d * 4 + (n + 1) * 4 + n * d * 4
    row["bound_ms"], row["bound_by"] = op_bound_ms(nbytes)
    row["max_abs_err"] = err
    log_row(tag, row, f"; {nbytes / 1e6:.2f} MB")
    return row


def profile_steps(tag, step, iters, unit):
    """torch.profiler over ``iters`` calls of ``step`` (one epoch or one
    optimizer iteration of a main path, at its own shapes): device time by
    kernel and the device's busy share of the wall time (the profiler's
    own overhead inflates the wall time, so the busy share is also quoted
    against the unprofiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for _ in range(iters):
            step()
    steps()                                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, kernels = device_kernels(prof)
    log(f"[profile] {tag}: {plain_wall * 1e3:.3f} ms host wall per {unit} "
        f"unprofiled; profiled {iters} {unit}s {wall * 1e3:.2f} ms wall, "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / 1e6 / wall:.1%} of "
        f"profiled wall, {busy_us / 1e6 / iters / plain_wall:.1%} of "
        f"unprofiled); {sum(c for _, c, _ in kernels) // iters} kernels/"
        f"{unit}")
    for t_us, count, name in kernels[:12]:
        log(f"[profile]   {t_us / iters:9.1f} us/{unit}  "
            f"x{count // iters:<3d} {name[:90]}")
    return plain_wall, busy_us / 1e3 / iters


def phase_profile_umap(y, lay, memb_n, ecfg):
    """PROFILE_EPOCHS of the main path's UMAP epoch at its own layout."""
    import torch
    from repro_torch.core import umap
    a, b = umap.fit_ab(ecfg.spread, ecfg.min_dist)
    n, e = y.shape[0], lay.src.shape[0]
    g = torch.Generator(device=y.device).manual_seed(2)
    state = {"y": y}

    def epoch():
        neg = torch.randint(0, n, (e, ecfg.neg_rate), generator=g,
                            device=y.device)
        state["y"] = state["y"] + 0.01 * umap.epoch_delta(
            state["y"], lay, memb_n, neg, a, b)
    profile_steps(f"UMAP epoch (N {n}, E {e})", epoch, PROFILE_EPOCHS,
                  "epoch")


def tsne_step_profile(tag, y, grad_fn, cfg):
    """PROFILE_ITERS optimizer iterations (exaggeration 1, final
    momentum) from a path's final embedding."""
    import torch
    from repro_torch.core import tsne
    state = {"s": tsne.TsneState(y.clone(), torch.zeros_like(y),
                                 torch.ones_like(y))}

    def it():
        grad, _ = grad_fn(state["s"].y)
        state["s"] = tsne._momentum_update(state["s"], grad,
                                           cfg.momentum_final, cfg)
    return profile_steps(tag, it, PROFILE_ITERS, "iteration")


def phase_tsne_sparse(device, pts, warm, spec):
    """Path S: CANCER_100K (sparse tSNE, exact kNN) on the main points;
    then K1, K2 and K3 at its shapes.  Returns the K2 and K3 entries and
    K1's row at these shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.sns_paper import CANCER_100K
    from repro_torch.core import neighbors, pipeline, tsne
    from repro_torch.kernels import cic

    cfg = dataclasses.replace(CANCER_100K, embed_knn_method="exact")
    ecfg = pipeline.resolve_embed_cfg(cfg)
    n_iter = ecfg.n_iter
    res, launches, _ = drive(
        "tsne-sparse", cfg, pts, warm, spec, device,
        {"segment_reduce": n_iter, "cic_splat": n_iter, "cic_gather": n_iter},
        tsne_cfg=tsne.TsneConfig(n_iter=20))
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    n = x.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = neighbors.knn_graph(x, min(ecfg.knn, n - 1), block=ecfg.block,
                                    method=ecfg.knn_method)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    sp = tsne.sparse_p_from_knn(idx, dist, ecfg.perplexity, weights=w,
                                search_iters=ecfg.sigma_search_iters)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0 - t_knn
    e = sp.src.shape[0]
    log(f"[tsne-sparse] embed breakdown (s): kNN (k {ecfg.knn}, {n} reps) "
        f"{t_knn:.3f}, P build {t_p:.3f}, iterations ~"
        f"{res.stage_seconds['embed'] - t_knn - t_p:.3f} (embed minus "
        f"these); E {e} edges, {int((sp.val > 0).sum())} nonzero")
    del idx, dist

    y, g = res.embedding, ecfg.grid_size
    diff = y[sp.src] - y[sp.dst]
    num = 1.0 / (1.0 + (diff * diff).sum(1))
    vals = (sp.val * num)[:, None] * diff
    gen = torch.Generator(device=device).manual_seed(4)
    vi = torch.randint(-1000, 1000, (e, 2), generator=gen,
                       device=device).float()
    k1 = segment_reduce_row("segment_reduce tsne-sparse", vi, vals,
                            sp.bounds, iters=20)
    k1["launches"] = launches.get("segment_reduce", 0)
    del diff, num, vals, vi

    i0, f, h = tsne._cic_weights(y, g)
    masses = torch.stack([torch.ones_like(y[:, 0]), y[:, 0], y[:, 1]], 1)
    grid = cic.cic_splat_cuda(i0, f, masses, g)
    conv1, conv0 = tsne._grid_convolve(grid, g, h)
    fields = torch.cat([conv1, conv0[None]]).contiguous()
    e2, e3 = check_cic(i0, f, masses, fields)
    occ = torch.bincount(i0[:, 0].long() * g + i0[:, 1].long(),
                         minlength=g * g)
    log(f"[kernels] cic at path S: N {n}, G {g}; points per cell: max "
        f"{int(occ.max())}, mean over occupied "
        f"{n / max(int((occ > 0).sum()), 1):.1f}, occupied cells "
        f"{int((occ > 0).sum())} of {g * g}")
    ix, iy = i0[:, 0].long(), i0[:, 1].long()
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    lib_idx = torch.cat([c * g * g + (ix + dx) * g + iy + dy
                         for c in range(3) for dx, dy in corners])
    lib_val = torch.cat([cic._corner_weight(f, dx, dy) * masses[:, c]
                         for c in range(3) for dx, dy in corners])
    k2 = timings({
        "ms": lambda: cic.cic_splat_cuda(i0, f, masses, g),
        "plain_ms": lambda: cic.cic_splat_torch(i0, f, masses, g),
        "library_ms": lambda: torch.zeros(3 * g * g, device=device
                                          ).index_add_(0, lib_idx, lib_val)},
        100)
    k2["bound_ms"], k2["bound_by"] = op_bound_ms(n * (8 + 8 + 12)
                                                 + 3 * g * g * 4)
    k2["max_abs_err"] = e2
    log_row("cic_splat", k2, "; library = one index_add_ over the "
            "flattened grid with precomputed corner indices")
    u = i0.float() + f
    grid_xy = (torch.stack([u[:, 1], u[:, 0]], 1) * (2.0 / (g - 1)) - 1.0
               )[None, None]

    def library_gather():
        return F.grid_sample(fields[None], grid_xy, mode="bilinear",
                             align_corners=True)
    lib_err = (library_gather()[0, :, 0].T - cic.cic_gather_cuda(
        fields, i0, f)).abs().max().item()
    k3 = timings({"ms": lambda: cic.cic_gather_cuda(fields, i0, f),
                  "plain_ms": lambda: cic.cic_gather_torch(fields, i0, f),
                  "library_ms": library_gather}, 100)
    k3["bound_ms"], k3["bound_by"] = op_bound_ms(n * (8 + 8 + 16)
                                                 + 4 * g * g * 4)
    k3["max_abs_err"] = e3
    log_row("cic_gather", k3, f"; library = F.grid_sample (bilinear, "
            f"align_corners), {lib_err:.3e} from the kernel")
    del grid, conv1, conv0, fields, lib_idx, lib_val, grid_xy
    tsne_step_profile(f"tSNE sparse iteration (N {n}, E {e}, G {g})", y,
                      lambda yy: tsne.sparse_grad(yy, sp, 1.0, g), ecfg)

    def entry(name, row, line):
        return dict({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/cic.cu",
                     "replaces": f"src/repro/kernels/cic.py:{line}",
                     "launches": launches.get(name, 0),
                     "shapes": {"n": n, "g": g}}, **row)
    return entry("cic_splat", k2, 57), entry("cic_gather", k3, 69), k1


def positive_pairs(xp, sp, n, rows=2048):
    """Valid pairs with P_ij > 0 in float32: where K5b takes its two logs."""
    import torch
    from repro_torch.core import tsne
    x = xp[:n]
    beta, shift, zp, w = sp[:n].unbind(1)
    c = 0.5 * w / zp
    ids = torch.arange(n, device=x.device)
    count = 0
    for lo in range(0, n, rows):
        d2 = tsne.pairwise_sq_dists(x[lo:lo + rows], x)
        p = c[lo:lo + rows, None] * torch.exp(
            -beta[lo:lo + rows, None] * d2 - shift[lo:lo + rows, None]) \
            + c[None, :] * torch.exp(-beta[None, :] * d2 - shift[None, :])
        valid = ids[lo:lo + rows, None] != ids[None, :]
        count += int(((p > 0) & valid).sum())
    return count


def phase_tsne_exact(device, pts, warm, spec):
    """Path E: the CANCER sketch with the fused exact tSNE gradient on
    the main points; then K5a and K5b at its shapes.  Returns their
    entries."""
    import torch
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline, tsne
    from repro_torch.kernels import tsne_forces as tf

    cfg = dataclasses.replace(CANCER, embedder="tsne", embed_backend="pallas",
                              embed_knn_method="exact")
    ecfg = pipeline.resolve_embed_cfg(cfg)
    n_iter = ecfg.n_iter
    res, launches, _ = drive("tsne-exact", cfg, pts, warm, spec, device,
                             {"tsne_z": n_iter, "tsne_forces": n_iter},
                             tsne_cfg=tsne.TsneConfig(n_iter=20))
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    n = x.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = tsne.calibrate_stats(x, ecfg.perplexity, weights=w,
                              search_iters=ecfg.sigma_search_iters,
                              block=ecfg.block)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    log(f"[tsne-exact] embed breakdown (s): calibration (P stats, {n} reps) "
        f"{t_p:.3f}, iterations ~{res.stage_seconds['embed'] - t_p:.3f} "
        f"(embed minus calibration)")
    blk = min(ecfg.block, n)
    xp, yp = tf.pad_rows(x, blk), tf.pad_rows(res.embedding, blk)
    sp = tf.step_stats(st.beta, st.zp, st.shift, st.w, blk)
    f_err, z_rel, kl_rel = check_tsne(xp, yp, sp, n, 1.0)
    log(f"[kernels] tsne at path E (N {n} padded to {xp.shape[0]}, exag 1):"
        f" force max_abs_err {f_err:.3e}, Z rel {z_rel:.3e}, KL rel "
        f"{kl_rel:.3e}")
    pairs = n * (n - 1)
    pos = positive_pairs(xp, sp, n)
    dh, dims, npad = xp.shape[1], yp.shape[1], xp.shape[0]
    log(f"[kernels] pairs {pairs}, with P > 0 {pos} ({pos / pairs:.1%})")
    z = tf.tsne_z_cuda(yp, n)
    k5a = timings({"ms": lambda: tf.tsne_z_cuda(yp, n),
                   "plain_ms": lambda: tf.tsne_z_torch(yp, n),
                   "library_ms": None}, 10)
    k5a["bound_ms"], k5a["bound_by"] = op_bound_ms(
        npad * dims * 4 + 4, flops=pairs * (3 * dims + 1), sfu=pairs)
    k5a["max_abs_err"] = z_rel * z.item()
    log_row("tsne_z", k5a)
    k5b = timings({
        "ms": lambda: tf.tsne_forces_cuda(xp, yp, sp, z, 1.0, n),
        "plain_ms": lambda: tf.tsne_forces_torch(xp, yp, sp, z, 1.0, n),
        "library_ms": None}, 10)
    k5b["bound_ms"], k5b["bound_by"] = op_bound_ms(
        npad * (dh + dims + 4) * 4 + 4 + npad * dims * 4 + 16,
        flops=pairs * (3 * dh + 5 * dims + 11) + pos * 4,
        sfu=pairs * 3 + pos * 2)
    k5b["max_abs_err"] = f_err
    log_row("tsne_forces", k5b)
    tsne_step_profile(f"tSNE exact fused iteration (N {n})", res.embedding,
                      lambda yy: tsne.embedding_grad(
                          x, yy, st, 1.0, backend="pallas",
                          block=ecfg.block), ecfg)

    def entry(name, row, line):
        return dict({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/tsne_forces.cu",
                     "replaces": f"src/repro/kernels/tsne_forces.py:{line}",
                     "launches": launches.get(name, 0),
                     "shapes": {"n": n, "n_pad": npad, "dh": dh,
                                "dims": dims, "pairs": pairs,
                                "pairs_p_positive": pos}}, **row)
    return entry("tsne_z", k5a, 58), entry("tsne_forces", k5b, 69)


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
                    help="points in the main paths' input (default: the "
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

    t_start = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} kernel source(s) in "
        f"{time.perf_counter() - t_start:.1f} s")
    for name, rep in reports.items():
        log(f"[build] {name}:\n{rep.strip()}")
    phase_check(device)
    pts, warm, spec = make_points(device, args.points)
    cfg, res, launches = phase_main(device, pts, warm, spec)
    k1 = phase_kernels(cfg, res, launches)
    del res
    k2, k3, k1_sparse = phase_tsne_sparse(device, pts, warm, spec)
    k1["launches"] += k1_sparse["launches"]
    k1["launches_by_path"] = {"umap": launches.get("segment_reduce", 0),
                              "tsne_sparse": k1_sparse["launches"]}
    k1["per_call"]["tsne_sparse"] = k1_sparse
    k5a, k5b = phase_tsne_exact(device, pts, warm, spec)
    del pts
    phase_parity(cfg, device)
    log(f"[done] whole run {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi_line())
    log(json.dumps({"kernels": [k1, k2, k3, k5a, k5b]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
