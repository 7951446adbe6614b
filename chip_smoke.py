#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--points N]

Phases, each failing the run (non-zero exit) if it fails:

1. build       — every CUDA kernel of the port, from the sources in this
                 checkout (one nvcc per source, all started together);
2. check       — each kernel against its plain PyTorch version before
                 anything large runs: K1 on a small CSR and at every
                 group width (mean rows 1-63, D 1-3); K2/K3 at
                 N = 100 003 on G = 128 and 1024 with points on the edge
                 cells (K2 also at N = 1 and with the masses scaled by
                 1e-4 and 1e4, each deterministic); K5a/K5b at N = 6000
                 padded to 6144, rows in the caller's order and in the
                 locality order, K5a on 3001 equal points (Z = n(n − 1)
                 exactly); K4 on random tiles (window padding,
                 self pairs, a half-empty last tile) at several (T, B,
                 D) and on a probe layout of N = 100 003 points; K6 at
                 N = 100 003, D ∈ {2, 8, 12} × log2_cols ∈ {6, 18, 22}
                 with points on bin edges and outside the grid; K7 at
                 R ∈ {1, 16} × log2_cols ∈ {6, 18, 22}, integer and
                 weighted; K8 (hash, gather and median in one kernel)
                 at Q = 40 000 with (R, C) ∈ {(16, 2^18), (8, 2^20),
                 (3, 2^18), (129, 2^16), (300, 2^16), (1024, 2^14)}
                 (the last three a warp a query), explicit keys and the
                 keys (0, start + j), by int32 view (signed zeros count);
3. main        — ``pipeline.run`` at the paper's cancer configuration
                 (``CANCER``, UMAP, exact kNN) on
                 ``gaussian_mixture(26_000_000, dims=8)``, the paper's 26M
                 post-cut pixels, after a small warm-up run: per-stage
                 times, #HH, #reps, coverage; asserts no NaN, K1's launch
                 count == 2·n_epochs, K7 = K8 = 1 (the sketch stage) and
                 blob separation of the reps labelled by their nearest
                 mixture centre (every one-shot path below asserts K7 =
                 K8 = 1 too);
4. kernels     — K1 at the main path's shapes against the plain version,
                 the library call and the memory bound; a profile of the
                 UMAP epoch;
5. tsne-sparse — path S: ``CANCER_100K`` (sparse tSNE, exact kNN, G 128,
                 500 iterations) on the same 26M points: stage times with
                 embed split into kNN, P build and iterations, #HH, #reps,
                 E, peak memory, first/last KL, blob separation; asserts
                 K1 = K2 = K3 = 500 launches; then the approximate kNN
                 graph of the same reps beside the exact one (build time,
                 recall ≥ 0.9), K1, K2, K3 at its shapes and a profile of
                 its iteration;
6. tsne-exact  — path E: the ``CANCER`` sketch with ``embedder="tsne"``,
                 ``embed_backend="pallas"`` (the fused exact gradient) on
                 the same points, the same prints; asserts K5a = K5b = 500
                 launches; then K5a, K5b at its shapes and a profile;
7. ann         — path A: ``CANCER_1M`` (10⁶ heavy hitters, sparse tSNE on
                 the approximate kNN graph, k 90, adaptive G up to 1024) on
                 the same points: the prints of path S plus the ANN build
                 split into stage 1 and NN-descent, E before and after the
                 dedupe, the final G; asserts K4 = probes × stage-1 chunks
                 and K1 = K2 = K3 = 500 launches and recall ≥ 0.9 on 8192
                 sampled rows against their exact rows (``knn_query``
                 against all N); then K4, K2 and K3 (at the final G) at
                 its shapes and a profile; then the reproducibility gate:
                 the optimizer on its P from one init, 100 iterations, G
                 checked every 40, run twice, must give equal bits and
                 the same G choices; prints the digests of the run's
                 sketch table, reps and ANN graph, which path M (d)
                 holds its own to;
8. stream      — path I: ``pipeline.run_streaming(CANCER, factory,
                 grid=None)`` over the same 26M points as host numpy
                 slices of 1 000 003: stage seconds (grid pass, ingest,
                 extract, embed), ingest points per second, evict_max,
                 coverage, #HH, the ingest stage's peak device memory, a
                 profile of the fold; asserts K7 = 400 (one per chunk
                 folded, padding chunks included), K8 = 1, K1 = 600, the
                 fitted grid == ``fit_grid`` on the whole array, the
                 streaming table bit-identical to the one-shot table at
                 the same hash parameters, and blob separation; prints
                 the overlap of its heavy hitters with the one-shot's;
9. ops         — the reference's fused-ingest entry points
                 (``kernels/ops.py``) on the first 2^20 points in 16
                 chunks: K6 (16 launches), K7 at R 16, C 2^16 and K8 on
                 40 000 keys, each equal to its plain version;
10. kernels    — K6, K7, K8 at the paths' shapes against the plain
                 versions, the library calls and the bounds; K7 on a
                 chunk and ``index_add_`` in turns, 7 rounds, each round
                 printed, with the adds issued and the adds a second;
                 K8 beside its gather floor (``torch.gather`` of the
                 precomputed (R, Q) buckets) and its L2 sector traffic;
11. service    — path V, the host tier: the same 26M points as 4 host
                 shards of 6.5M (the paper's sites).  ``run_resilient(
                 CANCER)`` with shard 3 dropped and flaky attempts:
                 asserts lost (3,), ingest coverage 0.75, retries ≥ 1, the
                 merged table bit-identical to the one-shot table of
                 shards 0-2, K7 = the chunks the jobs folded (counted at
                 their sources, retried attempts included), K8 = 1, K1 =
                 600.  Then ``SnsService(CANCER)``: ``update_shards`` of
                 all 4 (coverage 1, table bit-identical to the one-shot
                 table of all 26M; the same 4 jobs then collected by 1
                 thread and by 4, in turns), a cold refresh (K1 = 600,
                 K8 = 1), an
                 update of 2^20 new points (needs_refresh), a warm refresh
                 (matched reps, 30 epochs, K1 = 60), ``transform`` of the
                 2^20 points (finite; each rep as a query lands within
                 1e-3 of its embedding), ``assign_points_to_hh`` over the
                 26M (the first 2^20 labels bit-identical to the CPU run),
                 save/load (equal transform bits), and a corrupt newest
                 checkpoint that loads from its ``.bak`` (equal bits);
                 prints ingest points/s, refresh seconds, transform
                 queries/s with per-chunk p50/p99 and ``health()``;
12. mesh       — path M, the mesh tier on the paper's four sites: the same
                 26M points written once to a .npy that every rank maps,
                 copying only its own row block (6.5M × 8) to the card.
                 Layouts: 4 gloo ranks sharing the card as a (2, 2)
                 ("pod", "data") mesh, 1 nccl rank, and 4 nccl ranks (one
                 card each) where there are 4 cards; every rank a
                 process from torch.multiprocessing's spawn context, the
                 kernels built once by this process.  On each rank, after
                 a small warm-up: (a) ``pipeline.run(CANCER, shard,
                 mesh=)`` with no hash parameters: the merged table
                 equals the single-device one-shot table bit for bit,
                 total_count = 26M, the HH equal on every rank, the blobs
                 separate, K7 = K8 = 1 and K1 = 600 a rank; (b)
                 ``run_streaming(mesh=, shard_fn=)`` over the rank's
                 block in chunks of 65 536 with (a)'s grid: its table
                 equals (a)'s, K7 = one a chunk; (c) UMAP on (a)'s reps
                 over a 1-D embed mesh of all ranks: one epoch within
                 1e-4·scale of the single-device run from the same
                 generator, then ``embed_stage(embed_mesh=)``'s 300
                 epochs finite and separated with K1 = 600 a rank (one
                 rank: bit-identical to (a)'s embedding); (d)
                 ``pipeline.run(CANCER_1M, shard, mesh=)`` with
                 ``embed_mesh`` the same 1-D mesh: the sketch over the
                 ranks, then the ANN graph (k 90) and the sparse tSNE
                 (adaptive G up to 1024, path A's rate N/12) sharded over
                 them, 500 iterations; the table equals path A's, the
                 reps are the same on every rank (path A's on one rank),
                 the ANN graph equals a single-device build on the same
                 reps bit for bit (path A's on path A's reps), the
                 sharded gradient at the init and at the final map
                 within 1e-4·max|grad| of ``sparse_grad`` (padded rows
                 0; rank 0's K1, K2 and K3 inputs of the final map's
                 call held against their plain versions as path S's
                 are), the KL trace finite,
                 falling and the same on every rank, rank 0's 10-NN
                 purity ≥ 0.95 (path A's bar) and within 0.02 of one
                 device's map from the same reps, P and init,
                 K7 = K8 = 1, K4 = probes × ⌈⌈T/S⌉/1024⌉,
                 K1 = K2 = K3 = the iterations a rank; prints each
                 step's seconds (d split into sketch, ANN stage 1,
                 descent rounds, P build, iterations), the collectives'
                 ms an epoch (on card tensors, and on a gloo layout on
                 host tensors) and an iteration, and each rank's peak
                 device memory.
                 Launches count under ``M:<layout>:<step>:r<rank>``; a
                 rank that fails, times out or disagrees fails the run;
13. parity     — the sketch stage at 2^20 points on the card, bit-identical
                 to the port's CPU run, each at its default hash draw; the
                 streaming sketch stage likewise (table, reservoir, count,
                 evict_max, HH), and the ingest stage's peak memory at 26M
                 within 10 % of its peak at 2^20 points;
14. lm         — the LM stack's serving path (no TPU kernel lies on it):
                 the twin check, every SMOKE config and llama3.2-3b at
                 full width and depth 2 in f32 with the same weights
                 (drawn on the CPU) and prompt through prefill and 4
                 greedy decode steps on the card and on the CPU (logits
                 within LM_TWIN_TOL, tokens equal); then L1, llama3.2-3b
                 whole (28 layers, bf16, 7.21 GB), and L2, jamba-v0.1-52b
                 at full width cut to one superblock of 8 layers (all of
                 it is 103 GB in bf16, over the card's 80), each through
                 ``launch.serve.serve`` at B 8, prompt 512, gen 32 twice
                 on weights drawn on the card: finite logits, the final
                 position prompt + gen − 1, equal tokens; prints prefill
                 ms and tok/s, decode ms a step (p50, p99), aggregate
                 tok/s, the step's bound (weights, K/V and SSM states at
                 3.35 TB/s), a profile of 10 decode steps (launches, busy
                 share), peak memory; then prefill L − 1 and one decode
                 step against prefill L (L1 at 512, L2 at 256): in bf16
                 within LM_TF_BF16_TOL (max, relative to the logits'
                 scale, and mean), on the same weights in f32 within
                 LM_TF_TOL, and the bf16 decode step as close to the f32
                 prefill as the bf16 prefill (LM_BF16_DECODE_RATIO);
15. train      — the LM stack's training path: the twin check, every SMOKE
                 config in f32 (TF32 off) on the card and the CPU from
                 the same weights: the loss within TRAIN_TWIN_LOSS_TOL
                 relative and each gradient leaf within
                 TRAIN_TWIN_GRAD_TOL·max|g_leaf|, then one
                 ``make_train_step`` under AdamW and one under Adafactor
                 (weights within 1e-3·lr where |g| > TRAIN_TWIN_SURE·
                 max|g|, 2·lr elsewhere; optimizer statistics within
                 TRAIN_TWIN_GRAD_TOL·max|leaf|), and llama3.2-3b at full
                 width, depth 2, B 1 x S 256 (loss and gradients); T1,
                 llama3.2-3b whole (bf16, AdamW, remat, B 4 x S 2048 zipf
                 tokens, 6 steps, twice): finite, falling, the same loss
                 bits twice; prints step ms (p50), tokens/s, the 6·N·T
                 share of the bf16 peak, a profiled step, the AdamW
                 update against its bytes bound, peak memory; T2,
                 mamba2-130m whole through ``Trainer`` (Adafactor, B 8 x
                 S 2048, checkpoints every 4, the activation monitor): a
                 fault before step 10, the restart at 8, and the step-12
                 loss, weights and optimizer state equal to an
                 uninterrupted run's bit for bit, heavy hitters found,
                 K7 = one an observe, K8 = one a report; T3,
                 tinyllama-1.1b whole with Count-Sketch gradients (R 8,
                 C 2^20, top_k 10 000, momentum 0.9) then AdamW, B 4 x
                 S 2048, 3 steps: K7 = K8 = ceil(n / TENSOR_CHUNK) a
                 step, the kept count top_k plus the ties at the
                 threshold, the sent values and the new error exactly
                 the corrected gradient's on and off the kept set (the
                 error-feedback identity), step 1's K7 table within
                 1e-5·max|table| of the float64 plain version and K8's
                 first chunk equal to its plain version by int32 view;
                 K7 and K8 timed at T3's chunk (``per_call.train`` of
                 the kernels line);
16. lm-mesh    — the LM stack's training and serving on a mesh
                 (``launch/sharding.py``:
                 FSDP over "data", TP and EP over "model"), path M's
                 layouts (4 gloo ranks sharing the card as a (2, 2)
                 ("data", "model") mesh, 1 nccl rank as (1, 1), 4 nccl
                 ranks where there are 4 cards), each rank a spawned
                 process with the kernels built by this one; every gate
                 holds on every rank: (a) every SMOKE config in f32
                 (AdamW; Adafactor too on mamba2-130m and jamba), the act
                 modes in turn: one sharded step against one device's on
                 the same card from the same weights, the loss within
                 TRAIN_TWIN_LOSS_TOL relative, each gradient block within
                 TRAIN_TWIN_GRAD_TOL·max|g_leaf|, weights within 1e-3·lr
                 where |g| is sure and LM_MESH_FLIP everywhere, an MoE
                 model's dropped share exactly;
                 (b) llama3.2-3b at full width, depth 2, B 2 x S 256, and
                 qwen3-moe-235b-a22b at full width, depth 1, B 2 x S 128
                 (the sequence cut), f32: loss and gradients the same
                 way; (c) M-T1, llama3.2-3b bf16 AdamW remat B 4 x S 2048
                 (2 layers on gloo4, all 28 otherwise): the first step
                 twice from one draw with equal loss bits, 3 timed steps
                 (ms, tokens/s, collectives' ms, peak and reserved memory
                 a rank); (d) M-T3, tinyllama-1.1b (11 layers on gloo4)
                 with Count-Sketch gradients on a data-only mesh through
                 ``compress_and_reduce(axis_names=, mesh=)``: K7 = K8 =
                 ceil(n / TENSOR_CHUNK) a rank a step (counted under
                 ``LM:<layout>:T3:<step>:r<rank>``), the round's ms, then
                 one more round's sketch, merge and decompress ms apart;
                 the merged float table the same bits on every rank and
                 within (W - 1)·2⁻²⁴·Σ_w |table_w| of the float64 sum of
                 the ranks' tables, on integer-valued gradients equal to
                 one device's sketch of the summed gradient bit for bit;
                 (e) on 4 cards, M-J, jamba-v0.1-52b at full width, 8
                 layers, bf16 AdamW, B 4 x S 2048: step ms, tokens/s,
                 peak a card (and after the draw); (f) a
                 Trainer's checkpoints on the mesh restored onto one
                 device equal to the gathered shards, and a resume on the
                 mesh bit-exact; (g) serving on the mesh
                 (``init_decode_state(mesh=)``: the batch over "data"
                 when it fills it, the caches' sequence over "model", or
                 over every axis for one sequence): (g1) every SMOKE
                 config in f32 at B 4 and B 1, prefill and 6 decode steps
                 teacher-forced, within LM_TWIN_TOL·max|logits| of one
                 device's on the same card from the same weights; (g2)
                 llama3.2-3b at full width, depth 2, B 2 x prompt 256, and
                 qwen3-moe-235b-a22b at full width, depth 1, B 2 x prompt
                 128, f32, the same bar (TP blocks only on ranks sharing
                 a card); (g3) M-L1, phase lm's L1 cell (llama3.2-3b
                 bf16, B 8 x prompt 512, gen 32; 2 layers and gen 3 on
                 gloo4), (g4) M-LL (B 1 x prompt 8 192, gen 16, the KV
                 sequence over every axis), (g5) M-L2 on 4 cards
                 (jamba-v0.1-52b at full width, 8 layers): weights cut at
                 the draw, the same tokens twice, finite logits; prefill
                 ms, decode p50/p99, tok/s, collectives' ms and launches
                 a step, peak a rank, caches a rank against one device's;
                 beside each, this process's dry run of a decode step of
                 the cell on the layout (``launch/dryrun.py``: dot FLOPs,
                 collective bytes by kind, the roofline's three terms and
                 bound), and the gate that each rank's collectives,
                 counted in one real decode step, equal its dry run's
                 call for call.  ``--only lm-mesh [--layouts ...]`` runs
                 this phase alone.

Prints the nvidia-smi name/power-limit line, then one
``{"kernels": [...]}`` line (nine entries: K1-K4, K5a, K5b, K6-K8), then ``{"ok": true, "device": ...}`` last.
Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
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
CHECK_KNN_TILES = ((1, 128, 8), (37, 128, 8), (5, 200, 3), (3, 64, 64),
                   (2, 90, 17))     # (T, B, D); C = 3B
RECALL_ROWS = 8192                  # path A's recall sample
STREAM_SLICE = 1_000_003            # path I's host slices, ragged vs 65 536
CHECK_SKETCH_QUERIES = 40_000       # K8: the CANCER candidate pool
K8_WIDE = (300, 16)                 # K8 timed past 128 rows: (R, log2 C)
SERVICE_SHARDS = 4                  # path V: sites of 6.5M points each
SERVICE_FAULTS = dict(seed=1, drop_shards=(3,), flaky=0.5)  # shards 1, 2
#                                     fail their first attempt only
SERVICE_UPDATE = 1 << 20            # path V: new points, transform queries
K7_ROUNDS = 7                       # K7 and index_add_ timed in turns
MESH_RANKS = 4                      # path M: the paper's four sites
MESH_AXES = ("data", "pod")         # sharded over, innermost first
MESH_CHUNK = 65_536                 # path M (b): rows a streamed batch
MESH_TIMEOUT_S = 600                # path M: a layout's ranks, at most
MESH_COLLECTIVE_ROUNDS = 50         # path M: epochs of collectives timed
MESH_TSNE_ROUNDS = 20               # path M (d): iterations' collectives timed
# the sketch stage of every one-shot path: one scatter, one estimate
ONE_SHOT_SKETCH = {"sketch_update_table": 1, "sketch_estimate_table": 1}
LM_TWIN_TOL = 1e-4                  # lm: card vs CPU logits, f32, TF32 off
LM_SERVE = dict(batch=8, prompt_len=512, gen=32)     # lm: L1 and L2
LM_PROFILE_STEPS = 10
# lm: f32 teacher-forced gap, relative to max(1, |logits|) (measured 2.3e-5
# at L1's 28 layers)
LM_TF_TOL = 1e-3
# lm: bf16 teacher-forced gap, the reference's bar of 2e-2 held on the max
# relative to max(1, |logits|) and on the mean.  Entrywise rtol = atol =
# 2e-2 fails at full width on the CPU as on the card (chip_diag_lm.py: L1's
# gap max 7.2e-2, mean 1.39e-2 on the CPU, 7.0e-2 and 1.37e-2 on the card,
# the same weights and row), the rounding of a bf16 residual stream.
LM_TF_BF16_TOL = 2e-2
# lm: in bf16 the decode step is as close to the f32 prefill as the bf16
# prefill is (mean |d logits|; chip_diag_lm.py: ratio 1.00 on L1 and L2)
LM_BF16_DECODE_RATIO = 1.25
# each driven path's launches, by tag (K7 and K8 run on all of them)
PATH_LAUNCHES = {}


def log(*args):
    print(*args, flush=True)


def launches_by_path(op: str) -> dict:
    """{path tag: launches of ``op``} over the driven paths' runs that
    launched it (each counted from 0 just before its run)."""
    return {tag: ls.get(op, 0) for tag, ls in PATH_LAUNCHES.items()
            if ls.get(op, 0)}


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


def device_ms(fn, iters: int):
    """Mean device time per call (ms): the summed duration of the CUDA
    kernels ``iters`` calls run, from torch.profiler (CUPTI).  A profile
    can miss kernel records (on the card, a one-call profile came back
    empty now and then, and earlier one-shot K7 readings held 1, 2 or 3
    of 5 launches), so one whose count of any kernel is not a multiple
    of ``iters`` is taken again, once; None when that one misses too or
    the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us, rows = device_kernels(prof)
        if busy_us > 0 and all(count % iters == 0 for _, count, _ in rows):
            return busy_us / iters / 1e3
    return None


def busy_card_ms(fn, iters: int):
    """Mean device time per call (ms) from CUDA events around ``iters``
    calls queued behind a sleep kernel, so that the card never waits for
    the host: the kernels' durations plus the card's gaps between them.
    None when queueing the calls takes the host over 0.25 s (they wait
    for the card, whose time the back-to-back reading then is) or the
    sleep runs out before the host has queued them, twice."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host_s > 0.25:
        return None
    cycles = int(4e9 * host_s) + 2_000_000      # ~2 GHz, twice the need
    for _ in range(2):
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        torch.cuda._sleep(cycles)
        slept.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not slept.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def card_ms(fn, iters: int):
    """(device ms per call, how): from CUDA events with the card kept
    busy (:func:`busy_card_ms`), or where the calls wait for the card
    from the profiler's kernel records (:func:`device_ms`), or failing
    both the back-to-back time.  Events first: late in a long run the
    profiler's records proved incomplete (and a complete-looking one-shot
    K7 profile read 1.34 ms against 1.48 ms from events)."""
    dev = busy_card_ms(fn, iters)
    if dev is not None:
        return dev, "events"
    dev = device_ms(fn, iters)
    if dev is not None:
        return dev, "profiler"
    return time_cuda(fn, iters), "back-to-back"


def timings(fns, iters: int) -> dict:
    """Device ms and back-to-back ms of each named call (:func:`card_ms`);
    ``timed_by`` says how each device ms was taken."""
    row = {"timed_by": {}}
    for key, fn in fns.items():
        if fn is None:
            row[key] = row["call_" + key] = None
            continue
        row[key], row["timed_by"][key] = card_ms(fn, iters)
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


def check_splat(i0, f, vals, g):
    """K2 deterministic (two calls, equal bits) and, per cell, within
    1e-5·Σ|contributions| + 1e-6 of the float64 plain version (the
    fixed-point sums round each product to a multiple of 2^-s).  Returns
    the max abs error."""
    import torch
    from repro_torch.kernels import cic
    got = cic.cic_splat_cuda(i0, f, vals, g)
    if not torch.equal(got, cic.cic_splat_cuda(i0, f, vals, g)):
        raise AssertionError(f"cic_splat: two calls differ at G={g}")
    want = cic.cic_splat_torch(i0, f.double(), vals.double(), g)
    scale = cic.cic_splat_torch(i0, f.double(), vals.double().abs(), g)
    err = (got.double() - want).abs()
    if not bool((err <= 1e-5 * scale + 1e-6).all()):
        raise AssertionError(f"cic_splat: off by {err.max().item()} at G={g}")
    return err.max().item()


def check_cic(i0, f, vals, fields):
    """K2 as :func:`check_splat`; K3 bit-exact against the float32 plain
    version and deterministic.  Returns (K2 max abs err, K3 max abs err
    against the float64 plain version)."""
    import torch
    from repro_torch.kernels import cic
    g = fields.shape[-1]
    err = check_splat(i0, f, vals, g)
    got = cic.cic_gather_cuda(fields, i0, f)
    if not (torch.equal(got, cic.cic_gather_torch(fields, i0, f))
            and torch.equal(got, cic.cic_gather_cuda(fields, i0, f))):
        raise AssertionError(f"cic_gather: not bit-exact against the plain "
                             f"version at G={g}")
    err_g = (got.double() - cic.cic_gather_torch(
        fields.double(), i0, f.double())).abs().max().item()
    return err, err_g


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


def check_knn_tile(qx, qid, cx, cid):
    """K4 against the float64 plain version: the same +inf pattern,
    finite values within 1e-5·(|q|² + |c|²) (the scale at which the fp32
    Gram form rounds), a second call identical.  Returns (max abs err,
    max err over that scale)."""
    import torch
    from repro_torch.kernels import knn_tile
    got = knn_tile.distance_tiles_cuda(qx, qid, cx, cid)
    if not torch.equal(got, knn_tile.distance_tiles_cuda(qx, qid, cx, cid)):
        raise AssertionError("knn_dist_tiles: two calls differ")
    want = knn_tile.distance_tiles_torch(qx.double(), qid, cx.double(), cid)
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("knn_dist_tiles: +inf pattern differs from the "
                             "plain version")
    fin = torch.isfinite(want)
    scale = ((qx.double() ** 2).sum(2)[:, :, None]
             + (cx.double() ** 2).sum(2)[:, None, :])[fin]
    err = (got.double()[fin] - want[fin]).abs()
    rel = (err / scale.clamp(min=1e-30)).max().item() if err.numel() else 0.0
    if rel > 1e-5:
        raise AssertionError(f"knn_dist_tiles: off by {rel:.3e} of "
                             f"|q|²+|c|²")
    return (err.max().item() if err.numel() else 0.0), rel


def knn_tile_inputs(device, t, b, d, seed):
    """Random tiles: window padding (cid −1), every tile's own rows as
    self pairs, padded query rows and a half-empty last tile."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    c = 3 * b
    qx = torch.randn((t, b, d), generator=gen) * 3
    cx = torch.randn((t, c, d), generator=gen) * 3
    qid = torch.randint(0, 10 * b, (t, b), generator=gen, dtype=torch.int32)
    cid = torch.randint(0, 10 * b, (t, c), generator=gen, dtype=torch.int32)
    cid[0, :b] = -1
    qid[-1, b // 2:] = -1
    cid[-1, c // 2:] = -1
    cid[:, b:2 * b] = qid
    return [a.contiguous().to(device) for a in (qx, qid, cx, cid)]


def recall(got, want, rows=32768):
    """Mean share of each row of ``want`` that the same row of ``got``
    lists."""
    hits = 0
    for s in range(0, got.shape[0], rows):
        g, w = got[s:s + rows], want[s:s + rows]
        hits += int((g[:, :, None] == w[:, None, :]).any(1).sum())
    return hits / want.numel()


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


def locality_operands(xp, yp, sp, n):
    """The padded operands as ``tsne_step_fused`` hands them to the
    kernels: valid rows in ``locality_order``, padding last.  Returns
    ((x, y, stats), the order)."""
    import torch
    from repro_torch.kernels import tsne_forces as tf
    order = tf.locality_order(xp[:n])
    perm = torch.cat([order, torch.arange(n, xp.shape[0],
                                          device=xp.device)])
    return (xp[perm], yp[perm], sp[perm]), order


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
    from repro_torch.kernels import segment_reduce as segred
    for fan in (1, 3, 7, 15, 31, 63):               # every group width L
        sizes = torch.randint(0, 2 * fan + 1, (3000,), generator=g)
        sizes[::101] = 0
        b = torch.cat([torch.zeros(1, dtype=torch.int64),
                       sizes.cumsum(0)]).to(torch.int32)
        e = int(b[-1])
        errs = [check_segment_reduce(
                    torch.randint(-1000, 1000, (e, d), generator=g).float()
                    .to(device), torch.randn((e, d), generator=g).to(device),
                    b.to(device)) for d in (1, 2, 3)]
        log(f"[check] segment_reduce mean row {fan}, "
            f"{segred.group_lanes(3000, e)} lanes a row, D 1/2/3: bit-exact "
            f"on integers; random max_abs_err "
            + "/".join(f"{x:.3e}" for x in errs))
    for grid in (128, 1024):
        i0, f, vals, fields = cic_inputs(device, CHECK_CIC_POINTS, grid, grid)
        e2, e3 = check_cic(i0, f, vals, fields)
        scaled = [check_splat(i0, f, vals * m, grid) for m in (1e-4, 1e4)]
        e1 = check_splat(i0[:1], f[:1], vals[:1], grid)
        log(f"[check] cic_splat / cic_gather at N={CHECK_CIC_POINTS}, "
            f"G={grid} (edge cells included): splat deterministic, "
            f"max_abs_err {e2:.3e} (masses x1e-4 {scaled[0]:.3e}, x1e4 "
            f"{scaled[1]:.3e}; N=1 {e1:.3e}; each within "
            f"1e-5·Σ|contrib|+1e-6 per cell); gather bit-exact vs the f32 "
            f"plain version, {e3:.3e} vs f64")
    xp, yp, sp = tsne_inputs(device, CHECK_TSNE_POINTS, 512, 3)
    ordered, _ = locality_operands(xp, yp, sp, CHECK_TSNE_POINTS)
    for exag in (12.0, 1.0):
        for tag, ops in (("caller's", (xp, yp, sp)), ("locality", ordered)):
            f_err, z_rel, kl_rel = check_tsne(*ops, CHECK_TSNE_POINTS, exag)
            log(f"[check] tsne_z / tsne_forces at N={CHECK_TSNE_POINTS} "
                f"padded to {xp.shape[0]}, exag {exag}, {tag} order: force "
                f"max_abs_err {f_err:.3e}, Z rel {z_rel:.3e}, KL rel "
                f"{kl_rel:.3e}; deterministic")
    from repro_torch.kernels import tsne_forces as tf
    same = torch.zeros((3072, 2), device=device)
    same[:3001] = 1.5
    z_same = tf.tsne_z_cuda(same, 3001).item()
    if z_same != 3001 * 3000:
        raise AssertionError(f"tsne_z on 3001 equal points: {z_same}, not "
                             f"{3001 * 3000}")
    log(f"[check] tsne_z on 3001 equal points padded to 3072: Z "
        f"{z_same:.0f} = n(n - 1) exactly (off-diagonal tiles doubled, "
        f"diagonal tiles without j = i)")
    from repro_torch.core import ann
    for t, b, d in CHECK_KNN_TILES:
        err, rel = check_knn_tile(*knn_tile_inputs(device, t, b, d, t + b))
        log(f"[check] knn_dist_tiles at T={t}, B={b}, C={3 * b}, D={d} "
            f"(window padding, self pairs, half-empty last tile): +inf "
            f"pattern identical, max_abs_err {err:.3e} ({rel:.3e} of "
            f"|q|²+|c|²); deterministic")
    gen = torch.Generator(device="cpu").manual_seed(5)
    cent = torch.rand((10, 8), generator=gen)
    x = (cent[torch.randint(0, 10, (CHECK_CIC_POINTS,), generator=gen)]
         + 0.02 * torch.randn((CHECK_CIC_POINTS, 8), generator=gen)
         ).to(device)
    rot = ann._rotations(0, 1, x.shape[1])[0]
    lay = ann._probe_layout(x, 90, rot, ann.AnnConfig())
    err, rel = check_knn_tile(*lay[:4])
    log(f"[check] knn_dist_tiles on a probe layout of N={CHECK_CIC_POINTS} "
        f"points (T={lay[0].shape[0]}, B={lay[0].shape[1]}, D={x.shape[1]}, "
        f"partial last tile): max_abs_err {err:.3e} ({rel:.3e} of "
        f"|q|²+|c|²)")
    phase_check_sketch(device)


def hash_inputs(device, n, d, bins, seed):
    """Points on a [0, 1]^d grid of ``bins`` bins: uniform ones, a third
    exactly on bin edges, and some outside the grid (clamped)."""
    import numpy as np
    import torch
    from repro_torch.core import quantize
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.2, 1.2, size=(n, d)).astype(np.float32)
    pts[: n // 3] = (rng.integers(0, bins + 1, size=(n // 3, d))
                     / bins).astype(np.float32)
    grid = quantize.GridSpec(dims=d, bins=bins, lo=np.zeros(d),
                             hi=np.ones(d))
    return grid, torch.from_numpy(pts).to(device)


def check_hash_points(params, grid, pts, log2_cols):
    """K6 bit-exact against its plain version on the same card."""
    import torch
    from repro_torch.kernels import hash_points as hp
    b, s = hp.hash_points_cuda(params, grid, pts, log2_cols)
    wb, ws = hp.hash_points_torch(params, grid, pts, log2_cols)
    torch.cuda.synchronize()
    if not (torch.equal(b, wb) and torch.equal(s, ws)):
        raise AssertionError(f"hash_points: not bit-exact at D={grid.dims}, "
                             f"log2_cols={log2_cols}")
    return 0.0


def check_sketch_update(params, hi, lo, v, log2_cols, integer):
    """K7 into a table already holding counts: bit-exact against the
    plain version on integer values; weighted values per cell within
    1e-5·Σ|contributions to the cell| (its starting value included) of
    the float64 plain version.
    Returns the max abs error against the float64 plain version."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import sketch_update as su
    r = params.rows
    gen = torch.Generator(device=v.device).manual_seed(log2_cols)
    start = torch.randint(-5, 5, (r, 1 << log2_cols), generator=gen,
                          device=v.device).float()
    got = su.sketch_update_cuda(start.clone(), params, hi, lo, v)
    want = su.sketch_update_torch(start.double(), params, hi, lo, v)
    err = (got.double() - want).abs()
    if integer:
        if not torch.equal(got, want.float()):
            raise AssertionError(f"sketch_update: not bit-exact on integer "
                                 f"values at R={r}, log2_cols={log2_cols}")
    else:
        b, _ = hashing.hashes(params, hi, lo, log2_cols)
        base = (torch.arange(r, device=v.device) << log2_cols)[:, None]
        scale = start.abs().double().view(-1).index_add_(
            0, (base | b).reshape(-1),
            v.abs().double().expand(r, -1).reshape(-1)).view(r, -1)
        if not bool((err <= 1e-5 * scale).all()):
            raise AssertionError(f"sketch_update: weighted values off by "
                                 f"{err.max().item()} at R={r}, "
                                 f"log2_cols={log2_cols}")
    return err.max().item()


def same_bits(a, b) -> bool:
    """Equal float32 tensors by int32 view: signed zeros count."""
    import torch
    return a.dtype == b.dtype == torch.float32 and a.shape == b.shape and \
        torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_sketch_estimate(table, params, hi, lo, start):
    """K8 on both key sources against its plain version by int32 view:
    the keys (hi, lo), and the keys (0, start + j), j < Q, written into a
    slice of a larger tensor.  Returns the −0.0 estimates among them."""
    import torch
    from repro_torch.kernels import sketch_estimate as se
    q = hi.shape[0]
    want = se.estimate_torch(table, params, hi, lo)
    want_r = se.estimate_range_torch(table, params, start, q)
    got = se.estimate_cuda(table, params, hi, lo)
    out = torch.full((q + 2,), 7.0, device=table.device)
    se.estimate_range_cuda(table, params, start, out[1:q + 1])
    if not (same_bits(got, want) and same_bits(out[1:q + 1], want_r)
            and float(out[0]) == float(out[-1]) == 7.0):
        raise AssertionError(f"sketch_estimate: not bit-exact at R "
                             f"{params.rows}, C {table.shape[1]}, Q {q}")
    neg0 = -(1 << 31)
    return int((want.view(torch.int32) == neg0).sum()
               + (want_r.view(torch.int32) == neg0).sum())


def key_stream(device, n, universe, seed):
    """(hi, lo) int64 limbs of n keys drawn from ``universe`` distinct
    64-bit values."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randint(0, universe, (n,), generator=gen, device=device)
    k = (k * 0x9E3779B97F4A7C1) & ((1 << 62) - 1)
    return (k >> 32).contiguous(), (k & 0xFFFFFFFF).contiguous()


def phase_check_sketch(device):
    """K6, K7 and K8 against their plain versions."""
    import torch
    from repro_torch.core import hashing, prng
    for d in (2, 8, 12):
        grid, pts = hash_inputs(device, CHECK_CIC_POINTS, d,
                                {2: 1000, 8: 25, 12: 16}[d], d)
        params = hashing.make_params(prng.key(d, device=device), 16)
        for l2c in (6, 18, 22):
            check_hash_points(params, grid, pts, l2c)
    log(f"[check] hash_points at N={CHECK_CIC_POINTS}, R=16, D in (2, 8, "
        f"12) x log2_cols in (6, 18, 22), bin edges and outside points "
        f"included: bit-exact")
    n = CHECK_CIC_POINTS
    errs = []
    for r in (1, 16):
        params = hashing.make_params(prng.key(r, device=device), r)
        hi, lo = key_stream(device, n, n // 4, r)
        gen = torch.Generator(device=device).manual_seed(r)
        vi = torch.randint(-3, 4, (n,), generator=gen, device=device).float()
        vw = torch.randn((n,), generator=gen, device=device)
        vi[::7] = 0.0
        vw[::7] = 0.0
        for l2c in (6, 18, 22):
            check_sketch_update(params, hi, lo, vi, l2c, True)
            errs.append(check_sketch_update(params, hi, lo, vw, l2c, False))
    log(f"[check] sketch_update_table at N={n}, R in (1, 16) x log2_cols in "
        f"(6, 18, 22) onto tables holding counts: bit-exact on integer "
        f"values; weighted max_abs_err {max(errs):.3e} (within "
        f"1e-5·Σ|contrib| per cell)")
    q = CHECK_SKETCH_QUERIES
    negs = {}
    for r, l2c in ((16, 18), (8, 20), (3, 18), (129, 16), (300, 16),
                   (1024, 14)):
        params = hashing.make_params(prng.key(r, device=device), r)
        hi, lo = key_stream(device, q, 10 ** 12, r)
        table = torch.randn((r, 1 << l2c), generator=torch.Generator(
            device=device).manual_seed(r), device=device) * 100
        table[:, ::3] = 0.0
        table[:, 1::5] = table[:, 1::5].round().clamp(-2, 2)
        negs[r] = check_sketch_estimate(table, params, hi, lo, 3 << 30)
    log(f"[check] sketch_estimate_table at Q={q}, (R, C) in (16, 2^18), "
        f"(8, 2^20), (3, 2^18) (the general path), (129, 2^16), (300, 2^16)"
        f", (1024, 2^14) (a warp a query), explicit keys and the "
        f"keys (0, 3·2^30 + j) into a slice, a third of the cells 0 and a "
        f"fifth small integers: bit-exact by int32 view ({negs} -0.0 "
        f"estimates by R)")


def blob_separation(reps, emb, centers):
    """The reps labelled by their nearest mixture centre: (min distance
    between blob centroids in the map, max mean distance of a blob's
    points from its centroid, blobs present, share of reps nearest their
    own blob's centroid).  tests/test_umap.py holds the first above 1.5×
    the second; tests/test_sparse_tsne.py holds the last ≥ 0.95."""
    import torch
    labels = torch.cdist(reps.double(), centers.double()).argmin(1)
    present = labels.unique()
    means = torch.stack([emb[labels == a].double().mean(0) for a in present])
    intra = max((emb[labels == a].double() - mu).norm(dim=1).mean().item()
                for a, mu in zip(present, means))
    d = torch.cdist(means, means)
    inter = d[torch.triu(torch.ones_like(d, dtype=torch.bool), 1)]
    nearest = present[torch.cdist(emb.double(), means).argmin(1)]
    acc = (nearest == labels).double().mean().item()
    return inter.min().item(), intra, present.shape[0], acc


def knn_purity(reps, emb, centers, rows=20000):
    """Share of the 10 nearest map neighbours of ``rows`` sampled reps
    (exact, the rep itself left out) that come from the rep's own blob:
    the kNN accuracy of Kobak & Berens 2019 (Nat. Commun. 10:5416)."""
    import torch
    from repro_torch.core import neighbors
    labels = torch.cdist(reps.double(), centers.double()).argmin(1)
    gen = torch.Generator(device="cpu").manual_seed(3)
    pick = torch.randperm(emb.shape[0], generator=gen)[:rows].to(emb.device)
    nb, _ = neighbors.knn_query(emb[pick], emb, 11, block=512)
    return (labels[nb[:, 1:]] == labels[pick][:, None]).double().mean().item()


def make_points(device, n_points):
    """The main paths' input, made once: (points on the card, the same
    points on the host, warm-up points on the host, the mixture spec)."""
    import torch
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture
    spec = MixtureSpec(dims=8)
    warm, _ = gaussian_mixture(WARMUP_POINTS, spec, seed=2)
    t0 = time.perf_counter()
    pts_np, _ = gaussian_mixture(n_points, spec, seed=0)
    pts = torch.from_numpy(pts_np).to(device)
    torch.cuda.synchronize()
    log(f"[main] data: {n_points} x 8 float32 points on the card "
        f"({pts.numel() * 4 / 1e6:.0f} MB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    return pts, pts_np, warm, spec


def drive(tag, cfg, pts, warm, spec, device, expect, tsne_cfg=None,
          warm_tsne_cfg=None, min_knn_purity=None):
    """One small warm-up run (which loads the CUDA modules the path uses;
    tSNE at ``warm_tsne_cfg``), then ``pipeline.run(cfg, pts,
    tsne_cfg=tsne_cfg)`` with every launch count set to 0 just before it
    and read just after (``pts`` and ``warm`` may be chunk factories: the
    streaming path).  Asserts finite output of the right shape,
    ``expect`` {op: launches} (or a function of the result giving it),
    finite KL and blob separation: min inter > 1.5 × max intra, or, with
    ``min_knn_purity``, that share of map neighbours from the same blob
    (:func:`knn_purity`).  Returns the result; the launches go to
    ``PATH_LAUNCHES[tag]``."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import LAUNCHES

    t0 = time.perf_counter()
    pipeline.run(dataclasses.replace(cfg, top_k=2000), warm, device=device,
                 tsne_cfg=warm_tsne_cfg)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up run ({WARMUP_POINTS} points, top_k 2000) "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.run(cfg, pts, device=device, tsne_cfg=tsne_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    PATH_LAUNCHES[tag] = launches
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
    if callable(expect):
        expect = expect(res)
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
    inter, intra, n_blobs, acc = blob_separation(reps, emb, centers)
    purity = knn_purity(reps, emb, centers)
    log(f"[{tag}] blob separation over {n_blobs} blobs: min inter "
        f"{inter:.3f} vs max intra {intra:.3f}; centroid accuracy "
        f"{acc:.4f}; 10-NN purity {purity:.4f}")
    ok = inter > 1.5 * intra if min_knn_purity is None else \
        purity >= min_knn_purity
    if not (n_blobs == spec.n_clusters and ok):
        raise AssertionError(f"[{tag}] blobs do not separate")
    return res


def phase_main(device, pts, warm, spec):
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline
    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    res = drive("main", cfg, pts, warm, spec, device,
                {"segment_reduce": 2 * n_epochs, **ONE_SHOT_SKETCH})
    return cfg, res


def phase_kernels(cfg, res):
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
    row["lanes"] = segred.group_lanes(n, e)
    log_row(tag, row, f"; {nbytes / 1e6:.2f} MB; N {n}, E {e}, D {d}, "
            f"{row['lanes']} lanes a row")
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
    return (plain_wall, busy_us / 1e3 / iters,
            sum(c for _, c, _ in kernels) / iters)


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
    from repro_torch.configs.sns_paper import CANCER_100K
    from repro_torch.core import ann, neighbors, pipeline, tsne

    cfg = dataclasses.replace(CANCER_100K, embed_knn_method="exact")
    ecfg = pipeline.resolve_embed_cfg(cfg)
    n_iter = ecfg.n_iter
    res = drive(
        "tsne-sparse", cfg, pts, warm, spec, device,
        {"segment_reduce": n_iter, "cic_splat": n_iter, "cic_gather": n_iter,
         **ONE_SHOT_SKETCH},
        warm_tsne_cfg=tsne.TsneConfig(n_iter=20))
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
    st = {}
    t0 = time.perf_counter()
    a_idx, _ = ann.ann_knn_graph(x, idx.shape[1], ann.AnnConfig(), stats=st)
    torch.cuda.synchronize()
    t_ann = time.perf_counter() - t0
    rec = recall(a_idx, idx)
    log(f"[tsne-sparse] approximate kNN graph of the same {n} reps (k "
        f"{idx.shape[1]}): {t_ann:.3f} s (stage 1 {st['stage1_s']:.3f}, "
        f"NN-descent {st['descent_s']:.3f} in {st['descent_iters']} rounds, "
        f"changes {st['descent_changed']}) vs exact {t_knn:.3f} s; recall "
        f"against the exact graph {rec:.4f}")
    if rec < 0.9:
        raise AssertionError(f"[tsne-sparse] ANN recall {rec:.4f} < 0.9")
    del idx, dist, a_idx

    y, g = res.embedding, ecfg.grid_size
    diff = y[sp.src] - y[sp.dst]
    num = 1.0 / (1.0 + (diff * diff).sum(1))
    vals = (sp.val * num)[:, None] * diff
    gen = torch.Generator(device=device).manual_seed(4)
    vi = torch.randint(-1000, 1000, (e, 2), generator=gen,
                       device=device).float()
    k1 = segment_reduce_row("segment_reduce tsne-sparse", vi, vals,
                            sp.bounds, iters=20)
    del diff, num, vals, vi

    i0, f, masses, grid, fields = path_fields(y, g)
    e2, e3 = check_cic(i0, f, masses, fields)
    k2 = cic_splat_row("cic_splat", i0, f, masses, g, e2)
    k3 = cic_gather_row("cic_gather", fields, i0, f, e3)
    del grid, fields
    tsne_step_profile(f"tSNE sparse iteration (N {n}, E {e}, G {g})", y,
                      lambda yy: tsne.sparse_grad(yy, sp, 1.0, g), ecfg)

    def entry(name, row, line):
        return dict({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/cic.cu",
                     "replaces": f"src/repro/kernels/cic.py:{line}",
                     "shapes": {"n": n, "g": g}}, **row)
    return entry("cic_splat", k2, 57), entry("cic_gather", k3, 69), k1


def path_fields(y, g):
    """One FFT-repulsion pass's K2 and K3 operands at an embedding: cells,
    offsets, masses, the splatted grid and the fields as
    ``tsne.fft_repulsion`` hands them to K3 (a (4, G, G) view of a
    channels-last (G, G, 4) tensor)."""
    import torch
    from repro_torch.core import tsne
    from repro_torch.kernels import cic
    i0, f, h = tsne._cic_weights(y, g)
    masses = torch.stack([torch.ones_like(y[:, 0]), y[:, 0], y[:, 1]], 1)
    grid = cic.cic_splat_cuda(i0, f, masses, g)
    conv1, conv0 = tsne._grid_convolve(grid, g, h)
    fields = torch.stack([conv1[0], conv1[1], conv1[2], conv0], -1
                         ).permute(2, 0, 1)
    return i0, f, masses, grid, fields


def splat_atomics(i0, f, vals, g):
    """The 64-bit atomics one K2 call issues, counted by the kernel itself
    through its C entry's counter (the wrapper passes none); the counted
    call's grid must equal the wrapper's."""
    import torch
    from repro_torch.kernels import _build, cic
    n, c = vals.shape
    acc = torch.zeros((c * g * g + 1,), dtype=torch.int64, device=vals.device)
    out = torch.empty((c, g, g), device=vals.device)
    count = torch.zeros((1,), dtype=torch.int64, device=vals.device)
    fn = _build.entry("cic", "cic_splat_f32", cic.SPLAT_SIG)
    rc = fn(i0.data_ptr(), f.data_ptr(), vals.data_ptr(), n, c, g,
            acc.data_ptr(), out.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cic_splat (counted) launch failed: CUDA error "
                           f"{rc}")
    if not torch.equal(out, cic.cic_splat_cuda(i0, f, vals, g)):
        raise AssertionError("cic_splat: the counted call's grid differs")
    return int(count.item())


def cic_splat_row(tag, i0, f, masses, g, err):
    """K2 timed at a path's shapes beside its plain version, one
    ``index_add_`` of the precomputed corner products over the flattened
    grid, and the byte bound; the atomics it issues, counted by the
    kernel."""
    import torch
    from repro_torch.kernels import cic
    n, c = masses.shape
    occ = torch.bincount(i0[:, 0].long() * g + i0[:, 1].long(),
                         minlength=g * g)
    ix, iy = i0[:, 0].long(), i0[:, 1].long()
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    lib_idx = torch.cat([ch * g * g + (ix + dx) * g + iy + dy
                         for ch in range(c) for dx, dy in corners])
    lib_val = torch.cat([cic._corner_weight(f, dx, dy) * masses[:, ch]
                         for ch in range(c) for dx, dy in corners])
    lib = torch.zeros(c * g * g, device=masses.device)

    def library_splat():
        return lib.zero_().index_add_(0, lib_idx, lib_val)
    row = timings({"ms": lambda: cic.cic_splat_cuda(i0, f, masses, g),
                   "plain_ms": lambda: cic.cic_splat_torch(i0, f, masses, g),
                   "library_ms": library_splat}, 100)
    row["bound_ms"], row["bound_by"] = op_bound_ms(n * (8 + 8 + 4 * c)
                                                   + c * g * g * 4)
    row["max_abs_err"] = err
    row["atomics"] = splat_atomics(i0, f, masses, g)
    row["shapes"] = {"n": n, "g": g, "c": c}
    log_row(tag, row, f"; N {n}, G {g}; points per cell: max "
            f"{int(occ.max())}, mean over occupied "
            f"{n / max(int((occ > 0).sum()), 1):.1f}, occupied cells "
            f"{int((occ > 0).sum())} of {g * g}; 64-bit atomics a call, "
            f"counted by the kernel: {row['atomics']} ({4 * c * n} corner "
            f"products); library = index_add_ of the precomputed corner "
            f"products over the flattened grid (zeroed first)")
    return row


def cic_gather_row(tag, fields, i0, f, err):
    """K3 timed at a path's shapes on the path's own layout, beside its
    plain version, ``F.grid_sample`` (bilinear, align_corners, on a
    contiguous (1, C, G, G) copy: its own layout) and the byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cic
    g, n = fields.shape[-1], i0.shape[0]
    nchw = fields.contiguous()[None]
    u = i0.float() + f
    grid_xy = (torch.stack([u[:, 1], u[:, 0]], 1) * (2.0 / (g - 1)) - 1.0
               )[None, None]

    def library_gather():
        return F.grid_sample(nchw, grid_xy, mode="bilinear",
                             align_corners=True)
    lib_err = (library_gather()[0, :, 0].T - cic.cic_gather_cuda(
        fields, i0, f)).abs().max().item()
    row = timings({"ms": lambda: cic.cic_gather_cuda(fields, i0, f),
                   "plain_ms": lambda: cic.cic_gather_torch(fields, i0, f),
                   "library_ms": library_gather}, 100)
    row["bound_ms"], row["bound_by"] = op_bound_ms(n * (8 + 8 + 16)
                                                   + 4 * g * g * 4)
    row["max_abs_err"] = err
    row["shapes"] = {"n": n, "g": g}
    log_row(tag, row, f"; N {n}, G {g}; library = F.grid_sample "
            f"(bilinear, align_corners), {lib_err:.3e} from the kernel")
    return row


def pair_census(xp, sp, n, orders, rows=2048):
    """K5b's data-dependent work, from the valid rows' x and stats in
    float32 (base-2 exponents e = -beta·log2(e)·d² - shift·log2(e), as
    the kernel forms them): the valid pairs with max(e_ij, e_ji) >= -126,
    where it needs the distance in x and the exps and, P being > 0 there,
    takes its logs; and, for each row order, the share of warp steps that
    need no exp (32 consecutive rows of the order against one valid
    column: ``column``) and the share of 32 × 32 blocks (a warp's rows
    against a group of 32 columns) whose box bound, the kernel's skip
    test, puts every exponent below -126 (``group``)."""
    import torch
    from repro_torch.core import tsne
    beta, shift, _, _ = sp[:n].unbind(1)
    l2e = 1.4426950408889634
    nb, ns = -beta * l2e, -shift * l2e
    live, skip = 0, {}
    for name, o in orders.items():
        x, b, s = xp[:n][o], nb[o], ns[o]
        ids = torch.arange(n, device=x.device)
        steps = skipped = 0
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            d2 = tsne.pairwise_sq_dists(x[lo:hi], x)
            need = torch.maximum(b[lo:hi, None] * d2 + s[lo:hi, None],
                                 b[None, :] * d2 + s[None, :]) >= -126.0
            need &= ids[lo:hi, None] != ids[None, :]
            if not skip:
                live += int(need.sum())
            pad = (-need.shape[0]) % 32
            if pad:
                need = torch.cat([need, need.new_zeros((pad, n))])
            warps = need.view(-1, 32, n).any(1)
            steps += warps.numel()
            skipped += int((~warps).sum())
            del d2, need, warps
        pad = (-n) % 32
        inf = torch.full((pad, x.shape[1]), float("inf"), device=x.device)
        lo_g = torch.cat([x, inf]).view(-1, 32, x.shape[1]).amin(1)
        hi_g = torch.cat([x, -inf]).view(-1, 32, x.shape[1]).amax(1)
        ninf = torch.full((pad,), -float("inf"), device=x.device)
        bg, sg = torch.cat([b, ninf]).view(-1, 32), torch.cat(
            [s, ninf]).view(-1, 32)
        blocks = blocked = 0
        for g in range(0, lo_g.shape[0], 64):
            gap = torch.maximum(lo_g[None] - hi_g[g:g + 64, None],
                                lo_g[g:g + 64, None] - hi_g[None]).clamp(
                                    min=0)
            d2 = (gap * gap).sum(2)                          # (64, G)
            row = (bg[g:g + 64, :, None] * d2[:, None] + sg[
                g:g + 64, :, None]).amax(1) >= -126.0
            col = bg.amax(1)[None] * d2 + sg.amax(1)[None] >= -126.0
            blocks += d2.numel()
            blocked += int((~(row | col)).sum())
        skip[name] = {"column": skipped / steps, "group": blocked / blocks}
    return live, skip


def phase_tsne_exact(device, pts, warm, spec):
    """Path E: the CANCER sketch with the fused exact tSNE gradient on
    the main points; then K5a and K5b at its shapes, K5b on rows in the
    locality order (the main path's) and in the caller's, beside the
    order's own cost, the fused step's and three bounds.  Returns their
    entries."""
    import torch
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline, tsne
    from repro_torch.kernels import tsne_forces as tf

    cfg = dataclasses.replace(CANCER, embedder="tsne", embed_backend="pallas",
                              embed_knn_method="exact")
    ecfg = pipeline.resolve_embed_cfg(cfg)
    n_iter = ecfg.n_iter
    res = drive("tsne-exact", cfg, pts, warm, spec, device,
                {"tsne_z": n_iter, "tsne_forces": n_iter,
                 **ONE_SHOT_SKETCH},
                warm_tsne_cfg=tsne.TsneConfig(n_iter=20))
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
    (xo, yo, so), order = locality_operands(xp, yp, sp, n)
    errs = {}
    for tag, ops in (("morton", (xo, yo, so)), ("caller", (xp, yp, sp))):
        errs[tag] = check_tsne(*ops, n, 1.0)
        log(f"[kernels] tsne at path E (N {n} padded to {xp.shape[0]}, exag "
            f"1, rows in the {tag} order): force max_abs_err "
            f"{errs[tag][0]:.3e}, Z rel {errs[tag][1]:.3e}, KL rel "
            f"{errs[tag][2]:.3e}")
    f_err, z_rel, _ = errs["morton"]
    pairs = n * (n - 1)
    live, skip = pair_census(xp, sp, n, {
        "morton": order, "caller": torch.arange(n, device=device)})
    dh, dims, npad = xp.shape[1], yp.shape[1], xp.shape[0]
    log(f"[kernels] pairs {pairs}, with an exponent >= -126 (base 2; P > 0, "
        f"distances in x, exps and logs needed) {live} ({live / pairs:.1%}); "
        f"warp column steps needing no exp / 32x32 blocks K5b's box bound "
        f"skips: {skip['morton']['column']:.4f} / "
        f"{skip['morton']['group']:.4f} in the locality order, "
        f"{skip['caller']['column']:.4f} / {skip['caller']['group']:.4f} in "
        f"the caller's")
    z = tf.tsne_z_cuda(yo, n)
    k5a = timings({"ms": lambda: tf.tsne_z_cuda(yo, n),
                   "plain_ms": lambda: tf.tsne_z_torch(yo, n),
                   "library_ms": None}, 10)
    # Z is symmetric: the function needs each valid unordered pair's
    # reciprocal and 3 dims + 1 flops once; the first kernel's bound
    # counted every ordered pair
    k5a["bound_ms"], k5a["bound_by"] = op_bound_ms(
        npad * dims * 4 + 4, flops=pairs // 2 * (3 * dims + 1),
        sfu=pairs // 2)
    k5a["bound_ordered_pairs_ms"], _ = op_bound_ms(
        npad * dims * 4 + 4, flops=pairs * (3 * dims + 1), sfu=pairs)
    k5a["max_abs_err"] = z_rel * z.item()
    log_row("tsne_z", k5a, f"; bounds: each unordered pair once "
            f"{us(k5a['bound_ms'])} us ({pairs // 2} pairs), every ordered "
            f"pair {us(k5a['bound_ordered_pairs_ms'])} us")
    k5b = timings({
        "ms": lambda: tf.tsne_forces_cuda(xo, yo, so, z, 1.0, n),
        "plain_ms": lambda: tf.tsne_forces_torch(xo, yo, so, z, 1.0, n),
        "library_ms": None,
        "ms_caller_order": lambda: tf.tsne_forces_cuda(xp, yp, sp, z, 1.0, n),
        "order_ms": lambda: tf.locality_order(x),
        "step_ms": lambda: tf.tsne_step_fused(
            x, res.embedding, st.beta, st.zp, shift=st.shift, weights=st.w,
            block=blk, return_kl=True, order=order)}, 10)
    nbytes = npad * (dh + dims + 4) * 4 + 4 + npad * dims * 4 + 16
    # every valid pair needs its repulsion (the distance in y, one
    # reciprocal, 5 dims + 3 flops); only the live pairs, where an exponent
    # reaches -126, need the distance in x, both exps, p and the logs
    # (3 Dh + 12 flops, 4 special-function ops)
    k5b["bound_ms"], k5b["bound_by"] = op_bound_ms(
        nbytes, flops=pairs * (5 * dims + 3) + live * (3 * dh + 12),
        sfu=pairs + 4 * live)
    # the same with the distance in x of every pair, and the count
    # before K5b's redesign, with every exp as well
    flops = pairs * (3 * dh + 5 * dims + 11) + live * 4
    k5b["bound_exps_live_ms"], _ = op_bound_ms(nbytes, flops=flops,
                                               sfu=pairs + 4 * live)
    k5b["bound_all_exps_ms"], _ = op_bound_ms(nbytes, flops=flops,
                                              sfu=3 * pairs + 2 * live)
    k5b["max_abs_err"] = f_err
    k5b["skip_share"] = skip
    log_row("tsne_forces", k5b, f"; rows in the locality order; in the "
            f"caller's order {us(k5b['ms_caller_order'])} us; the order "
            f"itself {us(k5b['order_ms'])} us "
            f"({k5b['order_ms'] / k5b['ms']:.2%} of K5b, once a run); the "
            f"fused step given the order (permutations, K5a, K5b) "
            f"{us(k5b['step_ms'])} us; bounds: the data's need "
            f"{us(k5b['bound_ms'])} us, with the distances in x of every "
            f"pair {us(k5b['bound_exps_live_ms'])} us, with every exp too "
            f"{us(k5b['bound_all_exps_ms'])} us")
    tsne_step_profile(f"tSNE exact fused iteration (N {n})", res.embedding,
                      lambda yy: tsne.embedding_grad(
                          x, yy, st, 1.0, backend="pallas",
                          block=ecfg.block, order=order), ecfg)

    def entry(name, row, line):
        return dict({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/tsne_forces.cu",
                     "replaces": f"src/repro/kernels/tsne_forces.py:{line}",
                     "shapes": {"n": n, "n_pad": npad, "dh": dh,
                                "dims": dims, "pairs": pairs,
                                "pairs_live": live}}, **row)
    return entry("tsne_z", k5a, 58), entry("tsne_forces", k5b, 69)


def path_a_tsne_cfg(cfg):
    """Path A's tSNE config for ``cfg`` (CANCER_1M).  The rate scales with
    the reps: N/12, N/α for exaggeration α = 12 (Belkina et al. 2019,
    Nat. Commun. 10:5415; openTSNE's default).  At the default 200 the
    10⁶-point map has not spread out after 500 iterations and its blobs
    mix, on the exact kNN graph as on the ANN one
    (chip_diag_cancer_1m.py).  At N/12 the ten 10⁵-point blobs come out
    wide and touching: the spread ratio and the centroid accuracy
    straddle the UMAP (1.5×) and sparse-tSNE (0.95) bars from map to
    map, so the map is held to its neighbourhoods: ≥ 0.95 of each rep's
    map neighbours from its own blob."""
    from repro_torch.core import tsne
    return tsne.TsneConfig(learning_rate=cfg.top_k * cfg.max_replicas / 12)


def ann_launches(acfg, n, k, ranks=1):
    """K4's launches in one ANN build of ``n`` points on ``ranks`` ranks:
    a rank scores ⌈T/S⌉ of the T sorted tiles, ``_TILE_CHUNK`` a launch,
    once a probe."""
    from repro_torch.core import ann
    tiles = -(-n // ann._bucket_size(acfg, k))
    per_rank = -(-tiles // ranks)
    return acfg.probes * -(-per_rank // ann._TILE_CHUNK)


def phase_ann(device, pts, warm, spec):
    """Path A: CANCER_1M (sparse tSNE on the approximate kNN graph,
    adaptive grid) on the main points; then the ANN build's split, its
    recall on a row sample, K4, K2 and K3 at its shapes, and the
    reproducibility gate.  Returns K4's entry, K2's and K3's rows, and
    the digests of the run's sketch table, its reps and their ANN graph
    (path M (d) must give the same)."""
    import torch
    from repro_torch.configs.sns_paper import CANCER_1M
    from repro_torch.core import ann, neighbors, pipeline, tsne
    from repro_torch.kernels import knn_tile

    cfg = CANCER_1M
    tcfg = path_a_tsne_cfg(cfg)
    ecfg = pipeline.resolve_embed_cfg(cfg, tsne_cfg=tcfg)
    acfg = ecfg.ann or ann.AnnConfig()
    n_iter = ecfg.n_iter

    def knn_k(n):
        return min(ecfg.knn or max(8, round(3.0 * ecfg.perplexity)), n - 1)

    def expect(res):
        n = res.embedding.shape[0]
        return {"knn_dist_tiles": ann_launches(acfg, n, knn_k(n)),
                "segment_reduce": n_iter, "cic_splat": n_iter,
                "cic_gather": n_iter, **ONE_SHOT_SKETCH}
    # record the adaptive grid's choices: the last is the final G
    with GridSpy() as grids:
        res = drive(
            "ann", cfg, pts, warm, spec, device, expect, tsne_cfg=tcfg,
            warm_tsne_cfg=tsne.TsneConfig(n_iter=20), min_knn_purity=0.95)
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    n = x.shape[0]
    k = knn_k(n)
    g_final = grids[-1] if grids else ecfg.grid_size
    torch.cuda.synchronize()
    st = {}
    t0 = time.perf_counter()
    idx, dist = ann.ann_knn_graph(x, k, acfg, stats=st)
    torch.cuda.synchronize()
    t_ann = time.perf_counter() - t0
    ref = {"table": digest(one_shot_table(
        cfg, res.grid, pts, pipeline._hash_params(cfg, device, None))),
        "reps": digest(*res.reps), "ann_idx": digest(idx),
        "ann_dist": digest(dist), "n": n}
    log(f"[ann] digests (path M (d) must give the same): sketch table "
        f"{ref['table']}, reps {ref['reps']}, ANN graph indices "
        f"{ref['ann_idx']}, distances {ref['ann_dist']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = tsne.sparse_p_from_knn(idx, dist, ecfg.perplexity, weights=w,
                                search_iters=ecfg.sigma_search_iters)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    e, e_nz = sp.src.shape[0], int((sp.val > 0).sum())
    log(f"[ann] embed breakdown (s): ANN kNN (k {k}, {n} reps) {t_ann:.3f} "
        f"= stage 1 {st['stage1_s']:.3f} + NN-descent {st['descent_s']:.3f} "
        f"({st['descent_iters']} of {acfg.iters} rounds, changes "
        f"{st['descent_changed']}, exit at <= "
        f"{acfg.delta * n * k:.0f}), P build {t_p:.3f}, iterations ~"
        f"{res.stage_seconds['embed'] - t_ann - t_p:.3f} (embed minus "
        f"these); E {e} before the dedupe, {e_nz} after; adaptive G "
        f"{ecfg.grid_size} -> {g_final} (after each stage: {grids})")
    del dist
    gen = torch.Generator(device="cpu").manual_seed(7)
    rows = torch.randperm(n, generator=gen)[:RECALL_ROWS].to(device)
    t0 = time.perf_counter()
    exact, _ = neighbors.knn_query(x[rows], x, k + 1, block=256)
    # drop each row's own entry (a query is its own nearest corpus row)
    self_last = torch.sort((exact == rows[:, None]).to(torch.int8), dim=1,
                           stable=True)[1]
    exact = torch.gather(exact, 1, self_last)[:, :k]
    torch.cuda.synchronize()
    rec = recall(idx[rows], exact)
    log(f"[ann] recall of the ANN graph on {rows.shape[0]} sampled rows "
        f"against their exact rows (knn_query against all {n}, "
        f"{time.perf_counter() - t0:.3f} s): {rec:.4f}")
    if rec < 0.9:
        raise AssertionError(f"[ann] recall {rec:.4f} < 0.9")
    del exact, idx

    rot = ann._rotations(acfg.seed, 1, x.shape[1])[0]
    lay = ann._probe_layout(x, k, rot, acfg)
    args = [a[:ann._TILE_CHUNK] for a in lay[:4]]
    del lay
    err, rel = check_knn_tile(*args)
    qx, qid, cx, cid = args
    t, b, d = qx.shape
    c = cx.shape[1]
    base = (qx * qx).sum(2)[:, :, None] + (cx * cx).sum(2)[:, None, :]
    cxt = cx.transpose(1, 2)
    k4 = timings({
        "ms": lambda: knn_tile.distance_tiles_cuda(qx, qid, cx, cid),
        "plain_ms": lambda: knn_tile.distance_tiles_torch(qx, qid, cx, cid),
        "library_ms": lambda: torch.baddbmm(base, qx, cxt, alpha=-2.0)}, 20)
    nbytes = 4 * (t * b * c + t * b * d + t * b + t * c * d + t * c)
    k4["bound_ms"], k4["bound_by"] = op_bound_ms(nbytes,
                                                 flops=2 * d * b * c * t)
    k4["max_abs_err"] = err
    log_row("knn_dist_tiles", k4, f"; one stage-1 chunk T {t}, B {b}, C {c},"
            f" D {d}: {nbytes / 1e6:.1f} MB; {rel:.3e} of |q|²+|c|²; "
            f"library = torch.baddbmm(|q|²+|c|² precomputed (T, B, C), q, "
            f"cᵀ, alpha=-2): the same Gram form, no clamp, no masks")
    del args, qx, qid, cx, cid, base, cxt
    i0, f, masses, grid, fields = path_fields(res.embedding, g_final)
    e2, e3 = check_cic(i0, f, masses, fields)
    k2 = cic_splat_row("cic_splat ann", i0, f, masses, g_final, e2)
    k3 = cic_gather_row("cic_gather ann", fields, i0, f, e3)
    del i0, f, masses, grid, fields
    tsne_step_profile(f"tSNE sparse iteration on the ANN graph (N {n}, E "
                      f"{e}, G {g_final})", res.embedding,
                      lambda yy: tsne.sparse_grad(yy, sp, 1.0, g_final), ecfg)
    reproducibility_gate(sp, n, ecfg, device)
    return dict({"name": "knn_dist_tiles", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/knn_tile.cu",
                 "replaces": "src/repro/kernels/knn_tile.py:36",
                 "shapes": {"n": n, "k": k, "t": t, "b": b, "c": c, "d": d,
                            "probes": acfg.probes}}, **k4), k2, k3, ref


class GridSpy:
    """Records the adaptive grid's choices (``tsne._grid_for_span``'s
    results, one per stage) while the ``with`` block runs."""

    def __enter__(self):
        from repro_torch.core import tsne
        self.grids, self.orig = [], tsne._grid_for_span

        def spy(span, g, c):
            self.grids.append(self.orig(span, g, c))
            return self.grids[-1]
        tsne._grid_for_span = spy
        return self.grids

    def __exit__(self, *exc):
        from repro_torch.core import tsne
        tsne._grid_for_span = self.orig


def reproducibility_gate(sp, n, ecfg, device, n_iter=100, interval=40):
    """Path A's optimizer on its P from one init, ``n_iter`` iterations
    with G checked every ``interval``, run twice: the embeddings, the KL
    traces and the G choices must be equal bit for bit."""
    import zlib
    import torch
    from repro_torch.core import tsne
    cfg = dataclasses.replace(ecfg, n_iter=n_iter,
                              adaptive_interval=interval)
    y0 = 1e-4 * torch.randn((n, 2), generator=torch.Generator(
        device=device).manual_seed(11), device=device)
    runs = []
    for _ in range(2):
        with GridSpy() as grids:
            y, kl = tsne._optimize(
                y0, lambda yy, exag, g: tsne.sparse_grad(yy, sp, exag, g),
                cfg, adaptive=True)
        runs.append((y, kl, grids))
    (ya, ka, ga), (yb, kb, gb) = runs
    same = torch.equal(ya, yb) and torch.equal(ka, kb) and ga == gb
    crc = [f"{zlib.crc32(y.cpu().numpy().tobytes()):08x}" for y, _, _ in runs]
    log(f"[ann] reproducibility gate: the optimizer on path A's P from one "
        f"init, {n_iter} iterations, G checked every {interval} (from "
        f"{cfg.grid_size}: {ga} and {gb}), run twice: embeddings {crc[0]} "
        f"and {crc[1]}, KL traces equal {torch.equal(ka, kb)}; bit-identical: "
        f"{same}")
    if not same:
        raise AssertionError("[ann] path A's optimizer is not reproducible")


class IngestSpy:
    """Wraps ``stream.ingest_all`` (the pipeline calls it through the
    module) and records each call's final state and, on the card, the
    ingest stage's peak device memory: ``max_memory_allocated`` after
    ``reset_peak_memory_stats``, less what was allocated when the stage
    began."""

    def __enter__(self):
        import torch
        from repro_torch.core import stream
        self.calls, self.orig = [], stream.ingest_all

        def spy(state, *args, **kwargs):
            cuda = state.sketch.table.is_cuda
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            out = self.orig(state, *args, **kwargs)
            peak = None
            if cuda:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
            self.calls.append((out, peak))
            return out
        stream.ingest_all = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import stream
        stream.ingest_all = self.orig


def hh_overlap(a, b) -> float:
    """Share of b's live heavy-hitter keys that a holds too."""
    import torch
    from repro_torch.core import u64
    ka = u64.sort_key((a.key_hi[a.mask], a.key_lo[a.mask]))
    kb = u64.sort_key((b.key_hi[b.mask], b.key_lo[b.mask]))
    return torch.isin(kb, ka).double().mean().item()


def phase_stream(device, pts, pts_np, warm, spec):
    """Path I: ``run_streaming(CANCER, factory, grid=None)`` over the
    main points as host slices; returns what the kernel rows and the
    parity phase need: (config, final ingest state, the one-shot runs,
    the ingest stage's peak device bytes)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import candidates, pipeline, quantize, sketch, stream

    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    n = pts_np.shape[0]
    chunks = -(-n // cfg.ingest_chunk)
    b = cfg.ingest_superbatch
    folded = -(-chunks // b) * b

    def factory():
        return (pts_np[s:s + STREAM_SLICE] for s in range(0, n, STREAM_SLICE))

    def warm_factory():
        return iter([warm])
    with IngestSpy() as spy:
        res = drive(
            "stream", cfg, factory, warm_factory, spec, device,
            {"sketch_update_table": folded, "sketch_estimate_table": 1,
             "segment_reduce": 2 * n_epochs})
    state, peak = spy.calls[-1]
    st = res.stage_seconds
    log(f"[stream] {n} points as {-(-n // STREAM_SLICE)} host slices of "
        f"{STREAM_SLICE}: {chunks} chunks of {cfg.ingest_chunk}, {folded} "
        f"folded in superbatches of {b} ({folded - chunks} all-padding); "
        f"grid pass {st['grid']:.3f} s, ingest {st['ingest']:.3f} s "
        f"({n / st['ingest'] / 1e6:.2f} M points/s), extract "
        f"{st['extract']:.3f} s; evict_max {res.hh_error_bound}, coverage "
        f"{res.coverage:.4f}, #HH {int(res.hh.mask.sum())}; ingest stage "
        f"peak device memory {peak / 2**20:.2f} MiB above its start")
    t0 = time.perf_counter()
    rows = b * cfg.ingest_chunk
    buf = np.empty((rows, pts_np.shape[1]), np.float32)
    for _ in stream._superbatches(factory(), rows, lambda d: buf):
        pass
    t_pack = time.perf_counter() - t0

    grid = quantize.fit_grid(pts, cfg.bins)
    if res.grid != grid:
        raise AssertionError("[stream] the streaming grid differs from "
                             "fit_grid on the whole array")
    hp = pipeline._hash_params(cfg, device, None)
    key_hi, key_lo = quantize.points_to_keys(grid, pts)
    runs = candidates.sorted_runs(
        key_hi, key_lo, assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    del key_hi, key_lo
    table = sketch.update_runs(sketch.init(hp, cfg.log2_cols), runs).table
    if not torch.equal(table, state.sketch.table):
        raise AssertionError("[stream] the streaming table differs from the "
                             "one-shot table at the same hash parameters")
    _, hh1 = pipeline.sketch_stage(cfg, pts, grid, device=device)
    log(f"[stream] grid == fit_grid on the whole array; table bit-identical "
        f"to the one-shot table ({table.abs().sum().item():.0f} = Σ|cell|); "
        f"heavy hitters: {hh_overlap(res.hh, hh1):.4f} of the one-shot's "
        f"#HH {int(hh1.mask.sum())} also streamed (equal only while "
        f"evict_max is 0)")
    del table

    sub = [pts_np[:PARITY_POINTS]]

    def fold():
        s0 = stream.init(hp, cfg.log2_cols, cfg.candidate_pool
                         or 2 * cfg.top_k)
        return stream.ingest_all(s0, grid, sub, cfg.ingest_chunk, b)
    fold()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fold()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    busy_us, kernels = device_kernels(prof)
    per = PARITY_POINTS // cfg.ingest_chunk
    log(f"[stream] the fold profiled over {PARITY_POINTS} points ({per} "
        f"chunks): {t_prof * 1e3:.2f} ms wall, device busy "
        f"{busy_us / 1e3:.2f} ms ({busy_us / 1e6 / t_prof:.1%}), "
        f"{busy_us / per:.1f} us and "
        f"{sum(c for _, c, _ in kernels) // per} kernels a chunk")
    for t_us, count, name in kernels[:10]:
        log(f"[profile]   {t_us / per:9.1f} us/chunk  x{count // per:<3d} "
            f"{name[:90]}")
    log(f"[stream] host seconds beside device seconds at {n} points: ingest "
        f"{st['ingest']:.3f} s host wall, of which packing the slices into "
        f"superbatches alone takes {t_pack:.3f} s on the host; device busy "
        f"~{busy_us / 1e6 / per * folded:.3f} s ({folded} chunks at the "
        f"profiled rate)")
    return cfg, state, runs, peak


def one_shot_table(cfg, grid, pts, hp):
    """The one-shot sketch table of ``pts`` at hash parameters ``hp``."""
    from repro_torch.core import candidates, quantize, sketch
    key_hi, key_lo = quantize.points_to_keys(grid, pts)
    runs = candidates.sorted_runs(
        key_hi, key_lo, assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    del key_hi, key_lo
    return sketch.update_runs(sketch.init(hp, cfg.log2_cols), runs).table


def counted(tag, expect, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after (synchronized), kept as ``PATH_LAUNCHES[tag]`` and held to
    ``expect`` {op: launches} (or a function giving it after the run), ops
    not named there held to 0.  Returns (fn's result, wall seconds)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {op: c for op, c in LAUNCHES.items() if c}
    PATH_LAUNCHES[tag] = launches
    if callable(expect):
        expect = expect()
    want = {op: c for op, c in expect.items() if c}
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, expected {want}")
    return out, wall


def phase_service(device, pts, pts_np, spec):
    """Path V: ``run_resilient`` over 4 host shards with a dead and two
    flaky ones, then an ``SnsService`` through ingest, cold and warm
    refresh, transform, labelling and a checkpoint round trip."""
    import collections
    import shutil
    import threading
    import numpy as np
    import torch
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import faults, geo, pipeline, quantize
    from repro_torch.core import heavy_hitters as hh_mod
    from repro_torch.core import resilience, service, stream
    from repro_torch.data.synthetic import gaussian_mixture

    smi = nvidia_smi_line()
    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    n = pts_np.shape[0]
    per = -(-n // SERVICE_SHARDS)
    bounds = [(s * per, min(n, (s + 1) * per)) for s in range(SERVICE_SHARDS)]
    b = cfg.ingest_superbatch

    def superbatched(points):
        """Chunks one fold of ``points`` runs, padding chunks included."""
        return -(-(-(-points // cfg.ingest_chunk)) // b) * b
    folded = {s: superbatched(hi - lo) for s, (lo, hi) in enumerate(bounds)}
    calls = collections.Counter()
    lock = threading.Lock()

    def sources():
        """Each site's stream as host slices; a call is one attempt that
        reached its fold."""
        def factory(s):
            lo, hi = bounds[s]
            with lock:
                calls[s] += 1
            return (pts_np[a:min(a + STREAM_SLICE, hi)]
                    for a in range(lo, hi, STREAM_SLICE))
        return {s: (lambda s=s: factory(s)) for s in range(SERVICE_SHARDS)}
    grid = quantize.fit_grid(pts, cfg.bins)
    hp = pipeline._hash_params(cfg, device, None)
    expected = {s: float(hi - lo) for s, (lo, hi) in enumerate(bounds)}

    # 1. the resilient pipeline
    captured = []
    orig = geo.resilient_extract

    def spy(*args, **kwargs):
        captured.append(orig(*args, **kwargs))
        return captured[-1]
    geo.resilient_extract = spy
    try:
        res, wall = counted(
            "V:resilient",
            lambda: {"sketch_update_table": sum(
                calls[s] * folded[s] for s in calls),
                "sketch_estimate_table": 1, "segment_reduce": 2 * n_epochs},
            lambda: pipeline.run_resilient(
                cfg, sources(), grid, faults=faults.FaultPlan(
                    **SERVICE_FAULTS), expected_counts=expected,
                device=device))
    finally:
        geo.resilient_extract = orig
    ext = captured[-1]
    lo3 = bounds[SERVICE_SHARDS - 1][0]
    want = one_shot_table(cfg, grid, pts[:lo3], hp)
    same = torch.equal(ext.merged.table, want)
    del want
    st = res.stage_seconds
    log(f"[service] run_resilient over {SERVICE_SHARDS} shards of {per} "
        f"points ({SERVICE_FAULTS}): {wall:.3f} s (ingest {st['ingest']:.3f}"
        f" s, {ext.observed_count / st['ingest'] / 1e6:.2f} M points/s; "
        f"embed {st['embed']:.3f} s); lost {res.lost_shards}, ingest "
        f"coverage {res.ingest_coverage}, retries {ext.retries}, folds a "
        f"shard {dict(calls)}, hh_error_bound {res.hh_error_bound}, #HH "
        f"{int(res.hh.mask.sum())}; merged table == one-shot table of "
        f"shards 0-{SERVICE_SHARDS - 2}: {same}; launches "
        f"{PATH_LAUNCHES['V:resilient']}")
    if not (res.lost_shards == (SERVICE_SHARDS - 1,)
            and res.ingest_coverage == 0.75 and ext.retries >= 1 and same
            and bool(torch.isfinite(res.embedding).all())):
        raise AssertionError("[service] run_resilient's gates failed")
    del res, ext, captured

    # 2. the service
    scfg = service.ServiceConfig(refresh_drift=0.03)
    svc = service.SnsService(cfg, grid, service_cfg=scfg, device=device)
    calls.clear()
    up, wall = counted(
        "V:update_shards",
        lambda: {"sketch_update_table": sum(calls[s] * folded[s]
                                            for s in calls)},
        lambda: svc.update_shards(sources(), expected_counts=expected))
    want = one_shot_table(cfg, grid, pts, hp)
    same = torch.equal(svc.state.sketch.table, want)
    del want
    log(f"[service] update_shards of all {SERVICE_SHARDS}: {up['seconds']:.3f}"
        f" s, {up['points_per_sec'] / 1e6:.2f} M points/s, coverage "
        f"{up['coverage']}; table == one-shot table of all {n}: {same}")
    if not (up["coverage"] == 1.0 and same):
        raise AssertionError("[service] update_shards' gates failed")
    # the same 4 jobs collected by 1 thread and by 4, in turns: what the
    # threads buy on one card
    turns = []
    for workers in (1, SERVICE_SHARDS, SERVICE_SHARDS, 1):
        jobs = geo.shard_ingest_jobs(
            grid, sources(), seed=cfg.seed, rows=cfg.rows,
            log2_cols=cfg.log2_cols, pool=int(svc.state.cands.capacity),
            chunk_size=cfg.ingest_chunk, superbatch=b, device=device,
            hash_params=svc.state.sketch.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg = resilience.collect_shards(jobs, verify=True, device=device,
                                        max_workers=workers)
        torch.cuda.synchronize()
        turns.append((workers, time.perf_counter() - t0, max(
            st.attempt_seconds[-1] for st in agg.statuses)))
    del agg
    log("[service] collect_shards of the 4 jobs, in turns (workers, "
        "seconds, slowest job's seconds): " + ", ".join(
            f"({w}, {t:.3f}, {j:.3f})" for w, t, j in turns))
    cold, wall = counted("V:cold", {"segment_reduce": 2 * n_epochs,
                                    "sketch_estimate_table": 1},
                         lambda: svc.refresh(mode="cold"))
    log(f"[service] cold refresh {wall:.3f} s: {cold.embedding.shape[0]} "
        f"reps, {cold.n_iters} epochs")
    new, _ = gaussian_mixture(SERVICE_UPDATE, spec, seed=5)
    upd, _ = counted("V:update",
                     {"sketch_update_table": superbatched(SERVICE_UPDATE)},
                     lambda: svc.update(new))
    bound, floor = svc.error_bound(), \
        scfg.error_ratio * svc._cache.min_hh_count
    log(f"[service] update of {SERVICE_UPDATE} points: {upd['seconds']:.3f}"
        f" s, {upd['points_per_sec'] / 1e6:.2f} M points/s; pending "
        f"{upd['pending_fraction']:.4f} (refresh_drift "
        f"{scfg.refresh_drift}), error bound {bound} vs {floor}; "
        f"needs_refresh {upd['needs_refresh']}")
    if not upd["needs_refresh"]:
        raise AssertionError("[service] the update did not call for a "
                             "refresh")
    warm_iters = n_epochs // scfg.warm_factor
    warm, wall = counted("V:warm", {"segment_reduce": 2 * warm_iters,
                                    "sketch_estimate_table": 1},
                         lambda: svc.refresh())
    log(f"[service] warm refresh {wall:.3f} s: matched {warm.n_matched}, "
        f"new {warm.n_new}, {warm.n_iters} epochs")
    if not (warm.warm and warm.n_matched > 0 and warm.n_iters == warm_iters
            and bool(torch.isfinite(warm.embedding).all())):
        raise AssertionError("[service] the warm refresh's gates failed")

    q = torch.from_numpy(new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = svc.transform(q)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    step = scfg.transform_chunk
    laps = []
    for a in range(0, SERVICE_UPDATE, step):
        t0 = time.perf_counter()
        svc.transform(q[a:a + step])
        torch.cuda.synchronize()
        laps.append(time.perf_counter() - t0)
    laps.sort()
    c = svc._cache
    ident = (svc.transform(c.rep_x) - c.rep_y).abs().max().item()
    log(f"[service] transform of {SERVICE_UPDATE} queries: {t_all:.3f} s, "
        f"{SERVICE_UPDATE / t_all / 1e6:.3f} M queries/s; a chunk of {step} "
        f"(host queries, synchronized): p50 {laps[len(laps) // 2] * 1e3:.3f}"
        f" ms, p99 {laps[int(0.99 * (len(laps) - 1))] * 1e3:.3f} ms; "
        f"finite {bool(torch.isfinite(y).all())}; {c.rep_x.shape[0]} reps "
        f"as queries: max |transform − embedding| {ident:.3e}")
    if not (bool(torch.isfinite(y).all()) and ident <= 1e-3):
        raise AssertionError("[service] transform's gates failed")

    hh = hh_mod.from_candidates(svc.state.sketch, svc.state.cands,
                                cfg.top_k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = pipeline.assign_points_to_hh(grid, hh, pts, device=device)
    torch.cuda.synchronize()
    t_lab = time.perf_counter() - t0
    cpu = pipeline.assign_points_to_hh(
        grid, pipeline.HeavyHitters(*[t.cpu() for t in hh]),
        pts_np[:PARITY_POINTS], device="cpu")
    same = torch.equal(labels[:PARITY_POINTS].cpu(), cpu)
    log(f"[service] assign_points_to_hh over {n} points: {t_lab:.3f} s, "
        f"labelled share {(labels >= 0).double().mean().item():.4f}; the "
        f"first {PARITY_POINTS} bit-identical to the CPU run: {same}")
    if not same:
        raise AssertionError("[service] card and CPU labels differ")
    del labels

    ckpt = ROOT / "build" / "service_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    try:
        path = ckpt / "svc"
        probe = q[:step]
        want = svc.transform(probe)
        svc.save(path)
        back = service.SnsService.load(path, cfg, grid, service_cfg=scfg,
                                       device=device)
        same_load = torch.equal(back.transform(probe), want)
        svc.update(new[:step])
        svc.save(path)                     # the first generation → .bak
        faults.corrupt_file(stream._npz_path(path), seed=0)
        old = service.SnsService.load(path, cfg, grid, service_cfg=scfg,
                                      device=device)
        same_bak = torch.equal(old.transform(probe), want) and \
            stream.state_digest(old.state) == stream.state_digest(back.state)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[service] save/load: transform bits equal {same_load}; newest "
        f"generation corrupted, .bak loaded with equal bits and state "
        f"{same_bak}")
    if not (same_load and same_bak):
        raise AssertionError("[service] the checkpoint round trip failed")
    h = svc.health()
    log(f"[service] health(): {json.dumps(h, default=str)}")
    log(f"[service] {smi}")


class GeoSpy:
    """Wraps ``geo.geo_extract`` and ``geo.geo_extract_from_shards`` (the
    pipeline calls them through the module) and keeps each call's
    result, merged table included."""

    NAMES = ("geo_extract", "geo_extract_from_shards")

    def __enter__(self):
        from repro_torch.core import geo
        self.results, self.orig = [], {n: getattr(geo, n) for n in self.NAMES}

        def wrap(fn):
            def spy(*args, **kwargs):
                self.results.append(fn(*args, **kwargs))
                return self.results[-1]
            return spy
        for n, fn in self.orig.items():
            setattr(geo, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.core import geo
        for n, fn in self.orig.items():
            setattr(geo, n, fn)


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, on the host."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def mesh_layouts(n_cards: int):
    """(name, ranks, backend, ranks share cuda:0) of every path M layout:
    4 gloo ranks on one card, 1 nccl rank, and 4 nccl ranks where there
    are 4 cards."""
    layouts = [("gloo4", MESH_RANKS, "gloo", True),
               ("nccl1", 1, "nccl", False)]
    if n_cards >= MESH_RANKS:
        layouts.append(("nccl4", MESH_RANKS, "nccl", False))
    return layouts


def mesh_rank(rank, world, backend, shared, tmp, d_iters, queue):
    """One rank of path M (a spawned process): puts (rank, "ok", its
    report) or (rank, "error", the traceback) on ``queue``."""
    import traceback
    try:
        queue.put((rank, "ok", _mesh_rank(rank, world, backend, shared,
                                          Path(tmp), d_iters)))
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_rank(rank, world, backend, shared, tmp, d_iters):
    """Path M on one rank: (a) the one-shot ``pipeline.run(mesh=)`` on the
    rank's row block, (b) ``run_streaming(mesh=, shard_fn=)`` over the
    same block in chunks of MESH_CHUNK, (c) the UMAP embed over a 1-D
    embed mesh of all ranks, (d) ``run(CANCER_1M, mesh=)`` with the
    sparse tSNE and its ANN graph on that embed mesh, ``d_iters``
    iterations.  Returns launches, digests, gate values and seconds; the
    parent holds them to the gates."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import pipeline, umap
    from repro_torch.data.synthetic import MixtureSpec
    from repro_torch.kernels import LAUNCHES

    dev = torch.device("cuda", 0 if shared else rank)
    if shared:
        # four processes' caches share one card: grow segments in place
        # rather than strand freed blocks of one size
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    torch.cuda.set_device(dev)
    # every rank of path M runs on this host: rendezvous over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (2, world // 2) if world % 2 == 0 else (1, world)
    mesh = mesh_mod.init_mesh(rank, world, f"file://{tmp / 'rendezvous'}",
                              shape, ("pod", "data"), backend=backend)
    axes = MESH_AXES
    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    pts_all = np.load(tmp.parent / "points.npy", mmap_mode="r")
    n = pts_all.shape[0]
    rows_per, _ = mesh_mod.row_block(n, world)
    idx = mesh_mod.linear_index(mesh, axes)
    shard = torch.from_numpy(np.array(
        pts_all[idx * rows_per:(idx + 1) * rows_per])).to(dev)
    del pts_all
    centers = torch.as_tensor(np.asarray(MixtureSpec(dims=8).centers(0),
                                         np.float32), device=dev)
    rep = {"rank": rank, "index": idx, "rows": shard.shape[0], "secs": {},
           "launches": {}}

    def step(name, fn):
        torch.cuda.synchronize(dev)
        mesh_mod.all_reduce(torch.zeros((), device=dev), mesh, axes)
        LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        rep["secs"][name] = time.perf_counter() - t0
        rep["launches"][name] = {op: c for op, c in LAUNCHES.items() if c}
        return out

    def separation(res_reps, emb):
        reps = res_reps.points[res_reps.mask]
        inter, intra, n_blobs, acc = blob_separation(reps, emb, centers)
        return {"inter": inter, "intra": intra, "blobs": n_blobs,
                "acc": acc, "finite": bool(torch.isfinite(emb).all()),
                "shape": list(emb.shape)}

    # warm-up: the modules and kernels every step loads, on a small slice
    step("warm", lambda: pipeline.run(
        dataclasses.replace(cfg, top_k=2000), shard[:WARMUP_POINTS // world],
        mesh=mesh, data_axes=axes, device=dev))

    # (a) the one-shot sketch stage on every rank's row block
    with GeoSpy() as spy:
        res = step("a", lambda: pipeline.run(cfg, shard, mesh=mesh,
                                             data_axes=axes, device=dev))
    g = spy.results[-1]
    rep["a"] = {"table": digest(g.merged.table), "hh": digest(*res.hh),
                "total": float(g.total_count), "evict": float(g.evict_max),
                "n_hh": int(res.hh.mask.sum()), "coverage": res.coverage,
                "grid": [res.grid.lo, res.grid.hi],
                "embedding": digest(res.embedding),
                "stages": res.stage_seconds,
                **separation(res.reps, res.embedding)}
    del g

    # (b) the same block streamed in chunks through shard_fn
    nb = -(-shard.shape[0] // MESH_CHUNK)

    def shard_fn(i, b):
        return shard[b * MESH_CHUNK:(b + 1) * MESH_CHUNK], None
    with GeoSpy() as spy:
        res_b = step("b", lambda: pipeline.run_streaming(
            cfg, mesh=mesh, data_axes=axes, shard_fn=shard_fn,
            num_batches=nb, grid=res.grid, device=dev))
    g = spy.results[-1]
    rep["b"] = {"table": digest(g.merged.table), "hh": digest(*res_b.hh),
                "total": float(g.total_count), "evict": float(g.evict_max),
                "batches": nb, "stages": res_b.stage_seconds}
    del g, res_b

    # (c) UMAP on (a)'s representatives over a 1-D mesh of all ranks
    emesh = mesh_mod.make_embed_mesh()
    ecfg = pipeline.resolve_embed_cfg(cfg)
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    one = dataclasses.replace(ecfg, n_epochs=1)
    u1 = umap.run_umap(x, one, weights=w, generator=torch.Generator(
        device=dev).manual_seed(11))
    u2 = umap.run_umap(x, one, weights=w, mesh=emesh,
                       generator=torch.Generator(device=dev).manual_seed(11))
    rep["c_epoch1"] = {"err": (u1 - u2).abs().max().item(),
                       "scale": max(1.0, u1.abs().max().item())}
    rows_e, n_pad = mesh_mod.row_block(x.shape[0], world)
    y_blk = torch.zeros((rows_e, ecfg.dims), device=dev)
    part = torch.zeros((n_pad, ecfg.dims), device=dev)

    def collectives(y, p):
        for _ in range(MESH_COLLECTIVE_ROUNDS):
            mesh_mod.all_gather(y, emesh, mesh_mod.EMBED_AXIS)
            mesh_mod.all_reduce(p, emesh, mesh_mod.EMBED_AXIS)
    step("collectives", lambda: collectives(y_blk, part))
    if backend == "gloo":     # the same on host tensors: gloo alone
        step("collectives_host", lambda: collectives(y_blk.cpu(),
                                                     part.cpu()))
    reps, emb, _, _ = step("c", lambda: pipeline.embed_stage(
        dataclasses.replace(cfg, embed_mesh=emesh), res.grid, res.hh,
        device=dev))
    rep["c"] = {"embedding": digest(emb), "n": x.shape[0],
                **separation(reps, emb)}
    del res, reps, emb, x, w, u1, u2, y_blk, part
    torch.cuda.empty_cache()

    # (d) CANCER_1M: the sketch over the mesh, then the sparse tSNE and its
    # ANN graph over the embed mesh
    rep["d"] = _mesh_tsne_step(step, rank, world, dev, mesh, emesh, shard,
                               d_iters, centers)
    return rep


def _mesh_tsne_step(step, rank, world, dev, mesh, emesh, shard, n_iter,
                    centers):
    """Path M step (d) on one rank: ``run(CANCER_1M, shard, mesh=)`` with
    ``embed_mesh`` the 1-D mesh of all ranks (path A's tSNE config,
    ``n_iter`` iterations), after a small warm-up; then the first
    iteration's sharded gradient against ``sparse_grad`` on one device,
    and an iteration's collectives at the final G.  ``step`` is
    :func:`_mesh_rank`'s timer; rank 0 also measures the map's
    neighbourhood purity.  Returns the rank's report of the step."""
    import torch
    from repro_torch.configs.sns_paper import CANCER_1M
    from repro_torch.core import ann, pipeline, tsne
    from repro_torch.core import mesh as mesh_mod
    axis = mesh_mod.EMBED_AXIS
    cfg = dataclasses.replace(CANCER_1M, embed_mesh=emesh)
    tcfg = dataclasses.replace(path_a_tsne_cfg(CANCER_1M), n_iter=n_iter)
    step("warm_d", lambda: pipeline.run(
        dataclasses.replace(cfg, top_k=2000), shard[:WARMUP_POINTS // world],
        mesh=mesh, data_axes=MESH_AXES, tsne_cfg=tsne.TsneConfig(n_iter=20),
        device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    free_gib = torch.cuda.mem_get_info(dev)[0] / 2**30
    with GeoSpy() as geo_spy, AnnSpy() as ann_spy, PSpy() as p_spy, \
            GridSpy() as grids:
        res = step("d", lambda: pipeline.run(
            cfg, shard, mesh=mesh, data_axes=MESH_AXES, tsne_cfg=tcfg,
            device=dev))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    peak_reserved = torch.cuda.max_memory_reserved(dev) / 2**30
    x = res.reps.points[res.reps.mask]
    n = x.shape[0]
    emb, kl = res.embedding, res.kl_trace
    idx, dist = ann_spy.graphs[-1]
    st = ann_spy.stats
    out = {"table": digest(geo_spy.results[-1].merged.table),
           "evict": float(geo_spy.results[-1].evict_max),
           "reps": digest(*res.reps), "ann_idx": digest(idx),
           "ann_dist": digest(dist), "embedding": digest(emb),
           "kl": digest(kl), "n": n, "shape": list(emb.shape),
           "k": idx.shape[1], "finite": bool(torch.isfinite(emb).all()),
           "kl_finite": bool(torch.isfinite(kl).all()),
           "kl_first": kl[0].item(), "kl_last": kl[-1].item(),
           "iters": kl.shape[0], "stages": res.stage_seconds,
           "stage1_s": st["stage1_s"], "descent_s": st["descent_s"],
           "descent_iters": st["descent_iters"],
           "descent_changed": st["descent_changed"],
           "p_s": p_spy.seconds[-1], "grids": list(grids),
           "peak_gib": peak, "peak_reserved_gib": peak_reserved,
           "free_gib": free_gib}
    del idx, dist, ann_spy, geo_spy
    sp = p_spy.results[-1]
    del p_spy, res
    ecfg = pipeline.resolve_embed_cfg(cfg, tsne_cfg=tcfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    y0 = 1e-4 * torch.randn((n, 2), generator=gen, device=dev)
    if rank == 0:
        inter, intra, n_blobs, acc = blob_separation(x, emb, centers)
        out.update(purity=knn_purity(x, emb, centers), inter=inter,
                   intra=intra, blobs=n_blobs, acc=acc)
        # the same reps' graph built on one device, which the mesh build
        # must equal bit for bit
        si, sd = ann.ann_knn_graph(x, out["k"], CANCER_1M.embed_ann)
        out.update(single_idx=digest(si), single_dist=digest(sd))
        del si, sd
        # the same optimizer on one device, from the same init on the same
        # P: the map the sharded one is held to at any depth
        y1, kl1 = tsne._optimize(
            y0, lambda yy, exag, g: tsne.sparse_grad(yy, sp, exag, g), ecfg,
            adaptive=ecfg.grid_interval > 0)
        out.update(single_purity=knn_purity(x, y1, centers),
                   single_kl_last=kl1[-1].item(),
                   single_acc=blob_separation(x, y1, centers)[3])
        del y1, kl1
    del x
    # the sharded gradient against one device's on the same P: at the
    # run's own init (the first iteration: exaggerated, the first G) and
    # at its final map (no exaggeration, the final G), where rank 0 also
    # holds its K1, K2 and K3 inputs against their plain versions
    blk = tsne.sparse_p_block(sp, n, world, emesh.get_local_rank(axis))
    rows_per, n_pad = mesh_mod.row_block(n, world)
    g = out["grids"][-1] if out["grids"] else ecfg.grid_size
    for name, y, exag, grid, check in (
            ("grad", y0, ecfg.early_exaggeration, ecfg.grid_size, False),
            ("grad_last", emb, 1.0, g, rank == 0)):
        out[name] = sharded_grad_error(sp, blk, y, exag, grid, emesh,
                                       rows_per, n_pad, check_kernels=check)
    del sp, blk, y0, emb
    torch.cuda.empty_cache()
    # one iteration's collectives at the final G, on card tensors
    y_c = torch.zeros((rows_per, 2), device=dev)
    grid_c = torch.zeros((3 * g * g + 2,), device=dev)
    z_c, mean_c = torch.zeros((), device=dev), torch.zeros((2,), device=dev)

    def collectives():
        for _ in range(MESH_TSNE_ROUNDS):
            mesh_mod.all_gather(y_c, emesh, axis)
            mesh_mod.all_reduce(grid_c, emesh, axis)
            mesh_mod.all_reduce(z_c, emesh, axis)
            mesh_mod.all_reduce(mean_c, emesh, axis)
    step("d_collectives", collectives)
    out["g_final"] = g
    return out


def sharded_grad_error(sp, blk, y, exag, grid, emesh, rows_per, n_pad,
                       check_kernels=False):
    """``tsne.sparse_grad_shard`` on this rank's block ``blk`` of ``sp``
    at ``y`` against ``tsne.sparse_grad`` of the whole ``sp``: the
    largest error on the block's live rows, max|grad| (the gate's scale:
    at 10⁶ reps the entries are far below 1), the largest padded-row
    entry and |ΔKL|.  With ``check_kernels`` the K1, K2 and K3 inputs of
    the sharded call (this rank's edges, rows and grid) are held against
    the plain versions as path S's are (``check_segment_reduce``,
    ``check_cic``), and their max abs errors come back too."""
    import torch
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import tsne
    axis = mesh_mod.EMBED_AXIS
    n, lo = y.shape[0], blk.row_offset
    want, kl_w = tsne.sparse_grad(y, sp, exag, grid)
    y_blk = torch.cat([y, y.new_zeros((n_pad - n, 2))])[lo:lo + rows_per]
    with KernelInputSpy() as spy:
        got, kl_g = tsne.sparse_grad_shard(
            y_blk, blk, mesh_mod.all_gather(y_blk, emesh, axis), exag, grid,
            emesh, axis, n)
    live = max(0, min(rows_per, n - lo))
    out = {"err": (got[:live] - want[lo:lo + live]).abs().max().item()
           if live else 0.0, "gmax": want.abs().max().item(),
           "pad": got[live:].abs().max().item() if live < rows_per else 0.0,
           "kl": abs(kl_g.item() - kl_w.item()), "kl_single": kl_w.item(),
           "g": grid, "exag": exag}
    del want, got
    if check_kernels:
        vals, bounds = spy.args["segment_reduce"]
        gen = torch.Generator(device=vals.device).manual_seed(4)
        vi = torch.randint(-1000, 1000, vals.shape, generator=gen,
                           device=vals.device).float()
        e1 = check_segment_reduce(vi, vals, bounds)
        edges = vals.shape[0]
        del vi, vals
        i0, f, masses, _ = spy.args["cic_splat"]
        fields = spy.args["cic_gather"][0]
        e2, e3 = check_cic(i0, f, masses, fields)
        out["kernels"] = {"segment_reduce": e1, "cic_splat": e2,
                          "cic_gather": e3, "edges": edges,
                          "rows": i0.shape[0], "g": fields.shape[-1]}
    return out


class KernelInputSpy:
    """Wraps the K1, K2 and K3 wrappers where ``tsne`` calls them
    (``coo.segment_reduce``, ``cic.cic_splat``, ``cic.cic_gather``) and
    keeps each one's arguments of its last call."""

    _WRAPPED = (("coo", "segment_reduce"), ("cic", "cic_splat"),
                ("cic", "cic_gather"))

    def _modules(self):
        from repro_torch.core import coo
        from repro_torch.kernels import cic
        return {"coo": coo, "cic": cic}

    def __enter__(self):
        mods = self._modules()
        self.args, self.orig = {}, {}
        for mod, name in self._WRAPPED:
            fn = self.orig[name] = getattr(mods[mod], name)

            def spy(*args, _name=name, _fn=fn):
                self.args[_name] = args
                return _fn(*args)
            setattr(mods[mod], name, spy)
        return self

    def __exit__(self, *exc):
        mods = self._modules()
        for mod, name in self._WRAPPED:
            setattr(mods[mod], name, self.orig[name])


class AnnSpy:
    """Wraps ``ann.ann_knn_graph`` (``neighbors.knn_graph`` calls it
    through the module): hands it a ``stats`` dict and keeps each call's
    graph."""

    def __enter__(self):
        from repro_torch.core import ann
        self.graphs, self.stats, self.orig = [], {}, ann.ann_knn_graph

        def spy(*args, **kwargs):
            kwargs["stats"] = self.stats
            self.graphs.append(self.orig(*args, **kwargs))
            return self.graphs[-1]
        ann.ann_knn_graph = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import ann
        ann.ann_knn_graph = self.orig


class PSpy:
    """Wraps ``tsne.sparse_p_from_knn`` (``build_sparse_p`` calls it
    through the module): keeps each call's P and its seconds, each ending
    in a device synchronize."""

    def __enter__(self):
        import torch
        from repro_torch.core import tsne
        self.results, self.seconds, self.orig = [], [], \
            tsne.sparse_p_from_knn

        def spy(idx, *args, **kwargs):
            torch.cuda.synchronize(idx.device)
            t0 = time.perf_counter()
            self.results.append(self.orig(idx, *args, **kwargs))
            torch.cuda.synchronize(idx.device)
            self.seconds.append(time.perf_counter() - t0)
            return self.results[-1]
        tsne.sparse_p_from_knn = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import tsne
        tsne.sparse_p_from_knn = self.orig


def phase_mesh(device, pts, pts_np, spec, ref_a, layouts=None):
    """Path M: the mesh tier, every rank a process, on the paper's four
    sites.  Holds each layout's steps to their gates (see the module
    docstring; ``ref_a``: path A's digests, which step (d) must give) and
    counts every rank's launches under ``M``.  ``layouts`` (default: every
    one :func:`mesh_layouts` gives the visible cards) are run in turn."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs.sns_paper import CANCER, CANCER_1M
    from repro_torch.core import pipeline, quantize

    smi = nvidia_smi_line()
    cfg = dataclasses.replace(CANCER, embed_knn_method="exact")
    n_epochs = pipeline.resolve_embed_cfg(cfg).n_epochs
    tsne_iters = path_a_tsne_cfg(CANCER_1M).n_iter
    n = pts_np.shape[0]
    grid = quantize.fit_grid(pts, cfg.bins)
    table = digest(one_shot_table(cfg, grid, pts,
                                  pipeline._hash_params(cfg, device, None)))
    gc.collect()          # earlier paths' cycles, before their blocks go
    torch.cuda.empty_cache()
    log(f"[mesh] this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB on the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
        f"reserved); the card has {torch.cuda.mem_get_info()[0] / 2**30:.2f} "
        f"GiB free")
    root = Path(tempfile.mkdtemp(prefix="sns-mesh-"))
    ctx = mp.get_context("spawn")
    try:
        np.save(root / "points.npy", pts_np)
        log(f"[mesh] {n} points written once to {root} for the ranks to "
            f"map; the single-device one-shot table {table} (default hash "
            f"draw); {smi}")
        if layouts is None:
            layouts = mesh_layouts(torch.cuda.device_count())
        for name, world, backend, shared in layouts:
            tmp = root / name
            tmp.mkdir()
            t0 = time.perf_counter()
            reps = run_ranks(ctx, world, backend, shared, tmp,
                             (tsne_iters,))
            wall = time.perf_counter() - t0
            mesh_gates(name, world, reps, table, n, n_epochs, spec.n_clusters,
                       wall, smi)
            mesh_tsne_gates(name, world, reps, ref_a, tsne_iters,
                            spec.n_clusters, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_ranks(ctx, world, backend, shared, tmp, extra, target=None,
              timeout=MESH_TIMEOUT_S):
    """Spawn ``world`` ranks of ``target`` (default: path M's
    :func:`mesh_rank`; called as ``target(rank, world, backend, shared,
    tmp, *extra, queue)``) and return their reports by rank.  A rank that
    fails or outlives ``timeout`` seconds fails the run; every rank is
    stopped before this returns or raises."""
    import queue as queue_mod
    q = ctx.Queue()
    procs = [ctx.Process(target=target or mesh_rank,
                         args=(r, world, backend, shared, str(tmp), *extra,
                               q))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, errors = {}, []
    deadline = time.perf_counter() + timeout
    try:
        while len(reports) + len(errors) < world and not errors:
            try:
                rank, status, body = q.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                raise AssertionError(
                    f"[mesh] ranks timed out after {timeout} s: "
                    f"{world - len(reports)} of {world} did not report")
            if status == "ok":
                reports[rank] = body
            else:
                errors.append(f"rank {rank}:\n{body}")
        if errors:
            raise AssertionError("[mesh] a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"[mesh] rank process exit code "
                                     f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return [reports[r] for r in range(world)]


def mesh_gates(name, world, reps, table, n, n_epochs, n_blobs, wall, smi):
    """Path M's gates for one layout, its prints and its launches (under
    ``M:<layout>:<step>:r<rank>``)."""
    def per_epoch(r, step):
        secs = r["secs"].get(step)
        return "n/a" if secs is None else \
            f"{secs / MESH_COLLECTIVE_ROUNDS * 1e3:.3f}"
    first = reps[0]
    for r in reps:
        for s in ("a", "b", "c"):
            PATH_LAUNCHES[f"M:{name}:{s}:r{r['rank']}"] = r["launches"][s]
    nb = [r["b"]["batches"] for r in reps]
    want = {
        "a": lambda r: {"sketch_update_table": 1, "sketch_estimate_table": 1,
                        "segment_reduce": 2 * n_epochs},
        "b": lambda r: {"sketch_update_table": r["b"]["batches"],
                        "sketch_estimate_table": 1,
                        "segment_reduce": 2 * n_epochs},
        "c": lambda r: {"segment_reduce": 2 * n_epochs},
        "collectives": lambda r: {}, "collectives_host": lambda r: {}}
    fails = []
    for r in reps:
        tag = f"[mesh] {name} rank {r['rank']}"
        for s, fn in want.items():
            if s in r["launches"] and r["launches"][s] != fn(r):
                fails.append(f"{tag} step {s} launches {r['launches'][s]}, "
                             f"expected {fn(r)}")
        a, b, c, e1 = r["a"], r["b"], r["c"], r["c_epoch1"]
        checks = [
            (a["table"] == table, "(a) merged table != single-device table"),
            (a["total"] == n, f"(a) total_count {a['total']} != {n}"),
            (a["hh"] == first["a"]["hh"], "(a) HH differ between ranks"),
            (a["finite"] and a["blobs"] == n_blobs
             and a["inter"] > 1.5 * a["intra"], "(a) blobs do not separate"),
            (b["table"] == a["table"], "(b) streaming table != (a)'s"),
            (b["total"] == n, f"(b) total_count {b['total']} != {n}"),
            (e1["err"] <= 1e-4 * e1["scale"],
             f"(c) epoch 1 off by {e1['err']} (scale {e1['scale']})"),
            (c["finite"] and c["blobs"] == n_blobs
             and c["inter"] > 1.5 * c["intra"], "(c) blobs do not separate"),
            (a["shape"] == c["shape"] == [c["n"], 2],
             f"embedding shapes {a['shape']}, {c['shape']}"),
            (world > 1 or c["embedding"] == a["embedding"],
             "(c) one rank's mesh embedding != the single-device one")]
        fails += [f"{tag} {msg}" for ok, msg in checks if not ok]
    for r in reps:
        a, b, c = r["a"], r["b"], r["c"]
        log(f"[mesh] {name} rank {r['rank']} (block {r['index']}, {r['rows']}"
            f" rows): (a) run {r['secs']['a']:.3f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in a["stages"].items())
            + f"), #HH {a['n_hh']}, coverage {a['coverage']:.4f}, "
            f"evict_max {a['evict']}, table {a['table']}, separation "
            f"{a['inter']:.3f} vs {a['intra']:.3f}; (b) run_streaming "
            f"{r['secs']['b']:.3f} s over {b['batches']} batches (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in b["stages"].items())
            + f"), table {b['table']}; (c) epoch-1 max|single - mesh| "
            f"{r['c_epoch1']['err']:.3e} (scale {r['c_epoch1']['scale']:.3f})"
            f", embed_stage {r['secs']['c']:.3f} s on {c['n']} reps "
            f"({r['secs']['c'] / n_epochs * 1e3:.3f} ms an epoch, kNN and "
            f"replicas included), separation {c['inter']:.3f} vs "
            f"{c['intra']:.3f}, collectives "
            f"{per_epoch(r, 'collectives')} ms an epoch (one all_gather + "
            f"one all_reduce; on host tensors "
            f"{per_epoch(r, 'collectives_host')}); warm-up "
            f"{r['secs']['warm']:.3f} s; launches a {r['launches']['a']}, "
            f"b {r['launches']['b']}, c {r['launches']['c']}")
    slowest = {s: max(r["secs"][s] for r in reps) for s in ("a", "b", "c")}
    log(f"[mesh] {name}: {world} rank(s), the whole layout {wall:.1f} s "
        f"(spawn and import included); (a) {slowest['a']:.3f} s, (b) "
        f"{slowest['b']:.3f} s over {nb} batches, (c) {slowest['c']:.3f} s "
        f"(slowest rank); {smi}")
    if fails:
        raise AssertionError("\n".join(fails))


def mesh_tsne_gates(name, world, reps, ref_a, n_iter, n_blobs, smi):
    """Path M step (d)'s gates for one layout and its prints: path A's
    table bits; the same reps on every rank, path A's on one rank (on
    several, each site proposes its own candidate cells, so the heavy
    hitters may differ from one device's: the reference's geo extract);
    the ANN graph equal to a single-device build on the same reps bit
    for bit (and to path A's wherever the reps are path A's); the
    sharded gradient at the init and at the final map within
    1e-4·max|grad| of one device's, padded rows 0, rank 0's K1, K2 and K3
    inputs checked; a finite, falling KL trace, the same on every rank;
    rank 0's map purity ≥ 0.95 (path A's bar) and within 0.02 of the map
    one device makes from the same reps, P and init; the launches (under
    ``M:<layout>:d:r<rank>``)."""
    from repro_torch.core import ann
    acfg = ann.AnnConfig()
    first = reps[0]["d"]
    for r in reps:
        PATH_LAUNCHES[f"M:{name}:d:r{r['rank']}"] = r["launches"]["d"]
    fails = []
    for r in reps:
        d, gr = r["d"], r["d"]["grad"]
        tag = f"[mesh] {name} rank {r['rank']} (d)"
        want = {"sketch_update_table": 1, "sketch_estimate_table": 1,
                "knn_dist_tiles": ann_launches(acfg, d["n"], d["k"], world),
                "segment_reduce": n_iter, "cic_splat": n_iter,
                "cic_gather": n_iter}
        checks = [
            (r["launches"]["d"] == want,
             f"launches {r['launches']['d']}, expected {want}"),
            (d["table"] == ref_a["table"], "table != path A's"),
            (d["reps"] == first["reps"], "reps differ between ranks"),
            (world > 1 or d["reps"] == ref_a["reps"], "reps != path A's"),
            (d["ann_idx"] == first["single_idx"]
             and d["ann_dist"] == first["single_dist"],
             "ANN graph != the single-device build on the same reps"),
            (d["reps"] != ref_a["reps"] or (
                d["ann_idx"] == ref_a["ann_idx"]
                and d["ann_dist"] == ref_a["ann_dist"]),
             "ANN graph != path A's on path A's reps"),
            (all(q["err"] <= 1e-4 * q["gmax"] and q["pad"] == 0.0
                 for q in (gr, d["grad_last"])),
             f"sharded gradient off: first {gr}, last {d['grad_last']}"),
            (d["kl_finite"] and d["kl_last"] < d["kl_first"]
             and d["iters"] == n_iter,
             f"KL trace {d['kl_first']} -> {d['kl_last']} over "
             f"{d['iters']} iterations"),
            (d["kl"] == first["kl"] and d["embedding"] == first["embedding"],
             "KL trace or embedding differ between ranks"),
            (d["finite"] and d["shape"] == [d["n"], 2],
             f"embedding {d['shape']} not finite or of the wrong shape")]
        if r["rank"] == 0:
            checks.append(("kernels" in d["grad_last"],
                           "K1, K2, K3 inputs of (d) not checked"))
            # path A's bar, and within 0.02 of the map one device makes
            # on the same reps, P and init
            bar = max(0.95, d["single_purity"] - 0.02)
            checks.append((d["blobs"] == n_blobs and d["purity"] >= bar,
                           f"{d['blobs']} blobs, 10-NN purity "
                           f"{d['purity']:.4f} < {bar:.4f} (one device on "
                           f"the same reps {d['single_purity']:.4f})"))
        fails += [f"{tag} {msg}" for ok, msg in checks if not ok]
    for r in reps:
        d, st = r["d"], r["d"]["stages"]
        kin = d["grad_last"].get("kernels")
        iters = st["embed"] - d["stage1_s"] - d["descent_s"] - d["p_s"]
        coll = r["secs"]["d_collectives"] / MESH_TSNE_ROUNDS * 1e3
        log(f"[mesh] {name} rank {r['rank']} (d) run(CANCER_1M, mesh=) "
            f"{r['secs']['d']:.3f} s: sketch {st['sketch']:.3f}, replicas "
            f"{st['replicas']:.3f}, ANN stage 1 {d['stage1_s']:.3f}, "
            f"NN-descent {d['descent_s']:.3f} ({d['descent_iters']} rounds, "
            f"changes {d['descent_changed']}), P build {d['p_s']:.3f}, "
            f"{d['iters']} iterations ~{iters:.3f} ({iters / d['iters'] * 1e3:.3f}"
            f" ms an iteration, the block cut included); collectives "
            f"{coll:.3f} ms an iteration (one all_gather + three "
            f"all_reduce at G {d['g_final']}); G choices {d['grids']}; "
            f"{d['n']} reps, k {d['k']}; KL {d['kl_first']:.4f} -> "
            f"{d['kl_last']:.4f}; "
            + "; ".join(
                f"{what} gradient (exaggeration {q['exag']}, G {q['g']}) "
                f"max|single - mesh| {q['err']:.3e} (max|grad| "
                f"{q['gmax']:.3e}, relative "
                f"{q['err'] / max(q['gmax'], 1e-300):.3e}), "
                f"padded rows {q['pad']}, |KL single - "
                f"mesh| {q['kl']:.3e} of {q['kl_single']:.4f}"
                for what, q in (("first", d["grad"]),
                                ("final map's", d["grad_last"])))
            + f"; peak "
            f"device memory {d['peak_gib']:.2f} GiB allocated, "
            f"{d['peak_reserved_gib']:.2f} reserved (the card had "
            f"{d['free_gib']:.2f} GiB free as (d) began); warm-up "
            f"{r['secs']['warm_d']:.3f} s; launches {r['launches']['d']}"
            + (f"; blob separation {d['inter']:.3f} vs {d['intra']:.3f}, "
               f"centroid accuracy {d['acc']:.4f}, 10-NN purity "
               f"{d['purity']:.4f}; the same optimizer on one device (same "
               f"reps, P and init): purity {d['single_purity']:.4f}, "
               f"centroid accuracy {d['single_acc']:.4f}, last KL "
               f"{d['single_kl_last']:.4f}; the final map's sharded call's "
               f"kernel inputs ({kin['edges']} edges, {kin['rows']} rows, "
               f"G {kin['g']}) against their plain versions: max abs err "
               f"K1 {kin['segment_reduce']:.3e}, K2 {kin['cic_splat']:.3e}, "
               f"K3 {kin['cic_gather']:.3e}" if r["rank"] == 0 else ""))
    log(f"[mesh] {name} (d): table {first['table']}, reps {first['reps']} "
        f"(evict_max {first['evict']}), ANN graph {first['ann_idx']}/"
        f"{first['ann_dist']}, single-device build on the same reps "
        f"{first['single_idx']}/{first['single_dist']} (path A: "
        f"{ref_a['table']}, {ref_a['reps']}, {ref_a['ann_idx']}/"
        f"{ref_a['ann_dist']}); slowest rank "
        f"{max(r['secs']['d'] for r in reps):.3f} s; {smi}")
    if fails:
        raise AssertionError("\n".join(fails))


def phase_ops(device, pts, cfg):
    """The reference's fused-ingest entry points on the first 2^20 main
    points in chunks of ``cfg.ingest_chunk``: K6 and K7 once a chunk, K8
    once, each equal to its plain version on the card."""
    import torch
    from repro_torch.core import hashing, pipeline, quantize, sketch
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.kernels import sketch_estimate as se
    from repro_torch.kernels import sketch_update as su

    sub = pts[:PARITY_POINTS]
    grid = quantize.fit_grid(sub, cfg.bins)
    hp = pipeline._hash_params(cfg, device, None)
    l2c, step = 16, cfg.ingest_chunk
    kh, kl = quantize.points_to_keys(grid, sub)
    q_hi, q_lo = kh[:CHECK_SKETCH_QUERIES], kl[:CHECK_SKETCH_QUERIES]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    sk = sketch.init(hp, l2c)
    hashed = []
    for s in range(0, PARITY_POINTS, step):
        hashed.append(ops.hash_points(hp, grid, sub[s:s + step], l2c))
        sk = ops.sketch_update_fused(sk, kh[s:s + step], kl[s:s + step])
    est = ops.sketch_estimate_mxu(sk, q_hi, q_lo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    PATH_LAUNCHES["ops"] = launches
    chunks = PARITY_POINTS // step
    expect = {"hash_points": chunks, "sketch_update_table": chunks,
              "sketch_estimate_table": 1}
    if launches != expect:
        raise AssertionError(f"[ops] launches {launches}, expected {expect}")
    wb, ws = hashing.hashes(hp, kh, kl, l2c)
    same_hash = torch.equal(torch.cat([h[0] for h in hashed], 1), wb) and \
        torch.equal(torch.cat([h[1] for h in hashed], 1), ws)
    twin = su.sketch_update_torch(torch.zeros_like(sk.table), hp, kh, kl,
                                  torch.ones_like(kh, dtype=torch.float32))
    same_table = torch.equal(sk.table, twin)
    same_est = same_bits(est, se.estimate_torch(twin, hp, q_hi, q_lo))
    log(f"[ops] {PARITY_POINTS} points in {chunks} chunks of {step}, R "
        f"{hp.rows}, C 2^{l2c}: {wall:.3f} s, launches {launches}; "
        f"hash_points == hashing.hashes(points_to_keys): {same_hash}; "
        f"sketch_update_fused == the sketch.update twin: {same_table}; "
        f"sketch_estimate_mxu on {CHECK_SKETCH_QUERIES} keys == the "
        f"sketch.estimate twin: {same_est}")
    if not (same_hash and same_table and same_est):
        raise AssertionError("[ops] a fused-ingest entry point differs from "
                             "its plain version")


def k8_row(tag, table, params, hi, lo, n, iters):
    """K8 checked and timed on explicit keys (hi, lo), or with ``n`` and
    hi = lo = None on the keys (0, j), j < n: the fused kernel against
    its plain version (the chain it replaced: torch hashing, the (R, Q)
    signed gather, a sort), by int32 view; no single PyTorch call hashes,
    gathers and takes the median, so the library column is None.  Beside
    it the gather floor: ``torch.gather`` of the R·Q precomputed int64
    buckets from the same table.  The bound counts the keys read (16 B a
    query, explicit keys only), the output written (4 B a query) and the
    table cells the queries touch (4 B each, where the call finds them
    outside L2); the gathers' own traffic, R·Q 32-byte L2 sectors, is
    printed beside it."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import sketch_estimate as se
    r, l2c = params.rows, table.shape[1].bit_length() - 1
    q = hi.shape[0] if n is None else n
    if n is None:
        check_sketch_estimate(table, params, hi, lo, 0)
        b = hashing.hashes(params, hi, lo, l2c)[0]
        fns = {"ms": lambda: se.estimate_cuda(table, params, hi, lo),
               "plain_ms": lambda: se.estimate_torch(table, params, hi, lo)}
        key_bytes = 16 * q
    else:
        out = torch.empty(n, device=table.device)
        want = se.estimate_range_torch(table, params, 0, n)
        if not same_bits(se.estimate_range_cuda(table, params, 0, out), want):
            raise AssertionError(f"[kernels] {tag}: K8 differs from its plain "
                                 f"version")
        del want
        lo = torch.arange(n, device=table.device)
        b = hashing.hashes(params, torch.zeros_like(lo), lo, l2c)[0]
        del lo
        fns = {"ms": lambda: se.estimate_range_cuda(table, params, 0, out),
               "plain_ms": lambda: se.estimate_range_torch(table, params, 0,
                                                           n)}
        key_bytes = 0
    b = b.contiguous()
    cells = int(torch.unique(((torch.arange(r, device=b.device) << l2c)
                              [:, None] | b).reshape(-1)).numel())
    row = timings(dict(fns, library_ms=None), iters)
    row["gather_floor_ms"], how = card_ms(lambda: torch.gather(table, 1, b),
                                          iters)
    row["timed_by"]["gather_floor_ms"] = how
    nbytes = key_bytes + 4 * q + 4 * cells
    row["bound_ms"], row["bound_by"] = op_bound_ms(nbytes)
    row["max_abs_err"] = 0.0
    row["gather_sector_bytes"] = 32 * r * q
    row["shapes"] = {"r": r, "q": q, "log2_cols": l2c, "cells": cells,
                     "keys": "explicit" if n is None else "(0, j)"}
    log_row(tag, row, f"; R {r}, Q {q}, C 2^{l2c}, {cells} cells touched: "
            f"{nbytes / 1e6:.2f} MB; gathers {r * q} = "
            f"{32 * r * q / 1e6:.1f} MB of 32-byte L2 sectors; gather floor "
            f"(torch.gather of the precomputed (R, Q) buckets) "
            f"{us(row['gather_floor_ms'])} us ({how}); bit-exact by int32 "
            f"view; library: none (no one call hashes, gathers and takes "
            f"the median); timed by {row['timed_by']}")
    del b
    return row


def phase_sketch_kernels(device, pts, cfg, state, runs):
    """K6 on one chunk, K7 on one chunk's runs and on the one-shot's runs
    at CANCER, K8 (fused hash → gather → median) on the CANCER candidate pool
    (Q = 40 000): checked and timed against the plain versions, the
    library calls and the byte bounds.  Returns their kernels-line entries."""
    import torch
    from repro_torch.core import candidates, hashing, pipeline, prng, quantize
    from repro_torch.kernels import hash_points as hp_mod
    from repro_torch.kernels import sketch_update as su

    hp = pipeline._hash_params(cfg, device, None)
    grid = quantize.fit_grid(pts, cfg.bins)
    r, l2c, step = hp.rows, cfg.log2_cols, cfg.ingest_chunk
    chunk = pts[:step].contiguous()
    check_hash_points(hp, grid, chunk, l2c)
    k6 = timings({"ms": lambda: hp_mod.hash_points(hp, grid, chunk, l2c),
                  "plain_ms": lambda: hp_mod.hash_points_torch(hp, grid, chunk,
                                                               l2c),
                  "library_ms": None}, 100)
    d = grid.dims
    nbytes = step * d * 4 + 2 * r * step * 8 + 2 * d * 4 + 6 * r * 8
    k6["bound_ms"], k6["bound_by"] = op_bound_ms(nbytes)
    k6["max_abs_err"] = 0.0
    log_row("hash_points", k6, f"; one chunk N {step}, D {d}, R {r}: "
            f"{nbytes / 1e6:.2f} MB; bit-exact; no library call computes it; "
            f"through the main path's call; timed by {k6['timed_by']}")

    key_hi, key_lo = quantize.points_to_keys(grid, chunk)
    chunk_runs = candidates.sorted_runs(
        key_hi, key_lo, assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    sides = {}
    for side, rr, iters in (("chunk", chunk_runs, 100), ("oneshot", runs, 5)):
        hi, lo = rr.key_hi.contiguous(), rr.key_lo.contiguous()
        v = (rr.count * rr.live).contiguous()
        live = (v != 0).nonzero().squeeze(1)
        b, s = hashing.hashes(hp, hi[live], lo[live], l2c)
        idx = ((torch.arange(r, device=device) << l2c)[:, None] | b
               ).reshape(-1)
        vals = (s.float() * v[live][None, :]).reshape(-1)
        cells = int(torch.unique(idx).numel())
        err = check_sketch_update(hp, hi, lo, v, l2c, True)
        table = torch.zeros((r, 1 << l2c), device=device)
        flat = table.view(-1)

        def kernel():
            return su.sketch_update_cuda(table, hp, hi, lo, v)

        def plain():
            return su.sketch_update_torch(table, hp, hi, lo, v)

        def library():
            return flat.index_add_(0, idx, vals)
        n, n_live = hi.shape[0], live.shape[0]
        adds = n_live * r
        if side == "chunk":
            # the kernel and index_add_ in turns, device time a round
            row = timings({"plain_ms": plain}, iters)
            turns = {"ms": [], "library_ms": []}
            hows = []
            for _ in range(K7_ROUNDS):
                for key, fn in (("ms", kernel), ("library_ms", library)):
                    t, how = card_ms(fn, iters)
                    turns[key].append(t)
                    hows.append(how)
            pairs = list(zip(turns["ms"], turns["library_ms"]))
            for k, (tk, tl) in enumerate(pairs):
                log(f"[kernels] sketch_update_table chunk, round {k + 1} of "
                    f"{K7_ROUNDS}: kernel {us(tk)} us ({hows[2 * k]}), "
                    f"index_add_ {us(tl)} us ({hows[2 * k + 1]}) (device "
                    f"time a call, {iters} calls each)")
            for key, ts in turns.items():
                row[key] = statistics.median(ts)
                row[key + "_rounds"] = ts
            row["call_ms"] = time_cuda(kernel, iters)
            row["call_library_ms"] = time_cuda(library, iters)
            row["rounds_kernel_ahead"] = sum(tk < tl for tk, tl in pairs)
            row["timed_by"].update(
                ms=", ".join(sorted(set(hows[0::2]))),
                library_ms=", ".join(sorted(set(hows[1::2]))))
        else:
            row = timings({"ms": kernel, "plain_ms": plain,
                           "library_ms": library}, iters)
        nbytes = n * 4 + n_live * 16 + cells * 8
        row["bound_ms"], row["bound_by"] = op_bound_ms(nbytes)
        row["max_abs_err"] = err
        row["adds"] = adds
        row["shapes"] = {"n": n, "n_live": n_live, "cells": cells, "r": r,
                         "log2_cols": l2c}
        log_row(f"sketch_update_table {side}", row,
                f"; {n} run slots, {n_live} live, {cells} cells touched: "
                f"{nbytes / 1e6:.2f} MB; {adds} adds issued (live x R), "
                f"{adds / (row['ms'] * 1e-3) / 1e9:.1f}e9 adds/s by the "
                f"kernel, {adds / (row['library_ms'] * 1e-3) / 1e9:.1f}e9 "
                f"by the library; library = index_add_ of the live runs' "
                f"precomputed buckets and signed values (no hash)"
                + (f"; medians of {K7_ROUNDS} rounds, the kernel ahead in "
                   f"{row['rounds_kernel_ahead']}" if side == "chunk"
                   else ""))
        sides[side] = row
        del b, s, idx, vals, table, flat

    q_hi, q_lo = state.cands.key_hi.contiguous(), state.cands.key_lo.contiguous()
    k8 = k8_row("sketch_estimate_table", state.sketch.table, hp, q_hi, q_lo,
                None, 100)
    # R past the shared-memory path: a warp a query on the same keys
    wide = hashing.make_params(prng.key(K8_WIDE[0], device=device),
                               K8_WIDE[0])
    wide_table = torch.randn((K8_WIDE[0], 1 << K8_WIDE[1]), device=device,
                             generator=torch.Generator(device=device
                                                       ).manual_seed(300))
    k8["per_call"] = {"wide": k8_row(
        f"sketch_estimate_table R {K8_WIDE[0]}", wide_table, wide, q_hi,
        q_lo, None, 20)}
    del wide_table

    def entry(name, row, line, path):
        return dict({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/sketch.cu",
                     "replaces": f"src/repro/kernels/{path}:{line}"}, **row)
    # the top-level numbers are one chunk's: path I launches K7 once a
    # chunk, the one-shot paths once on all their runs (per_call)
    k7 = dict(sides["chunk"], max_abs_err=max(
        s["max_abs_err"] for s in sides.values()), per_call=sides)
    return (entry("hash_points", k6, 28, "hash_points.py"),
            entry("sketch_update_table", k7, 38, "sketch_update.py"),
            entry("sketch_estimate_table", k8, 27, "sketch_estimate.py"))


def phase_parity(cfg, device, stream_peak, stream_points):
    """Sketch stage on the card vs the port's CPU run, each at its own
    default hash draw (the reference's threefry bits on both devices):
    one-shot, then streaming (the fold's table, reservoir, count and
    watermark too).  The card's streaming run also gives the ingest
    stage's peak memory at 2^20 points, which path I's at 26M must be
    within 10 % of."""
    import torch
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture

    pts, _ = gaussian_mixture(PARITY_POINTS, MixtureSpec(dims=8), seed=1)
    t0 = time.perf_counter()
    g_gpu, hh_gpu = pipeline.sketch_stage(cfg, pts, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_cpu, hh_cpu = pipeline.sketch_stage(cfg, pts, device="cpu")
    t2 = time.perf_counter()
    same = g_gpu == g_cpu and all(
        torch.equal(a.cpu(), b) for a, b in zip(hh_gpu, hh_cpu))
    log(f"[parity] sketch stage at {PARITY_POINTS} points: card "
        f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s, #HH "
        f"{int(hh_cpu.mask.sum())}, bit-identical: {same}")
    if not same:
        raise AssertionError("card and CPU heavy hitters differ")

    def factory():
        return (pts[s:s + 100_003] for s in range(0, PARITY_POINTS, 100_003))
    out = {}
    with IngestSpy() as spy:
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            out[str(dev)] = pipeline.sketch_stage_streaming(
                cfg, factory, device=dev)
            torch.cuda.synchronize()
            out[str(dev) + "_s"] = time.perf_counter() - t0
    (s_gpu, peak), (s_cpu, _) = spy.calls
    (g1, hh1, n1), (g2, hh2, n2) = out[str(device)], out["cpu"]
    same = g1 == g2 and n1 == n2 == PARITY_POINTS and all(
        torch.equal(a.cpu(), b) for a, b in zip(
            [s_gpu.sketch.table, *s_gpu.cands, s_gpu.count, s_gpu.evict_max,
             *hh1],
            [s_cpu.sketch.table, *s_cpu.cands, s_cpu.count, s_cpu.evict_max,
             *hh2]))
    log(f"[parity] streaming sketch stage at {PARITY_POINTS} points (host "
        f"slices of 100 003): card {out[str(device) + '_s']:.3f} s, CPU "
        f"{out['cpu_s']:.3f} s, evict_max {s_cpu.evict_max.item()}, #HH "
        f"{int(hh2.mask.sum())}; table, reservoir, count, evict_max and HH "
        f"bit-identical: {same}; streaming HH vs one-shot: "
        f"{hh_overlap(hh2, hh_cpu):.4f}")
    if not same:
        raise AssertionError("card and CPU streaming folds differ")
    log(f"[parity] ingest stage peak device memory above its start: "
        f"{peak / 2**20:.2f} MiB at {PARITY_POINTS} points, "
        f"{stream_peak / 2**20:.2f} MiB at {stream_points} points (path I)")
    if abs(stream_peak - peak) > 0.1 * peak:
        raise AssertionError("the ingest stage's peak memory grows with the "
                             "stream's length")


def lm_twin(tag, cfg, batch, prompt, steps, device):
    """The same weights (drawn on the CPU from a seed, then copied to the
    card) and prompt through ``serve``'s prefill and ``steps`` greedy
    decode steps on the CPU and on the card, in f32 (TF32 off): the logits
    within LM_TWIN_TOL and the same greedy tokens at every step."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod

    model = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    runs = [serve.serve(cfg, batch, prompt, steps + 1, seed=0, device=dev,
                        model=model.to(dev)) for dev in ("cpu", device)]
    pairs = [(a, b.cpu()) for a, b in zip(runs[0].logits, runs[1].logits)]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(a.abs().max()) for a, _ in pairs)
    same = torch.equal(runs[0].tokens, runs[1].tokens.cpu())
    log(f"[lm] twin {tag}: card vs CPU, f32, B {batch}, prompt {prompt}, "
        f"{steps} decode steps: max |d logits| {err:.3e} (|logits| <= "
        f"{scale:.3f}), greedy tokens equal: {same}")
    if not same or not all(torch.allclose(b, a, rtol=LM_TWIN_TOL,
                                          atol=LM_TWIN_TOL)
                           for a, b in pairs):
        raise AssertionError(f"{tag}: the card's logits or tokens differ "
                             f"from the CPU's")


def lm_step_bytes(model, cfg, batch, pos) -> int:
    """Bytes one decode step at ``pos`` must move at the least: every weight
    it reads once (all but the embedding table, of which only the batch's
    rows; the MoE's static-capacity einsum reads every expert), the K/V
    slots it attends (pos + 1 of each) and the new slot it writes, the
    Mamba2 states read and written, the f32 logits written."""
    el = model.embed.element_size()
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    if model.lm_head is not None:
        n -= model.embed.numel() * el - batch * cfg.d_model * el
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            n += 2 * batch * (pos + 2) * cfg.num_kv_heads * cfg.head_dim * el
        else:
            h = cfg.padded_ssm_heads(1)
            d_in = h * (cfg.d_inner // cfg.ssm_heads)
            n += 2 * (batch * d_in * cfg.ssm_state * 4
                      + batch * (cfg.ssm_conv_width - 1)
                      * (d_in + 2 * cfg.ssm_state) * el)
    return n + batch * model.embed.shape[0] * 4


def lm_teacher_forced(cfg, model, batch, length, device):
    """A prefill over ``length`` tokens, and a prefill over ``length`` − 1
    then one decode step: the two f32 logits (B, V) on the CPU."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    tokens = serve.make_batch(cfg, batch, length,
                              torch.Generator().manual_seed(3),
                              device)["tokens"]
    prefill = make_prefill_step(cfg, length)
    full, _ = prefill(model, {"tokens": tokens})
    _, st = prefill(model, {"tokens": tokens[:, :-1]})
    step, _ = make_decode_step(cfg)(model, tokens[:, -1:], st)
    return full.cpu(), step.cpu()


def lm_gap(a, ref):
    """(max |a − ref|, mean |a − ref|, the share outside rtol = atol =
    2e-2 of ref)."""
    d = (a - ref).abs()
    return (float(d.max()), float(d.mean()),
            float((d > 2e-2 + 2e-2 * ref.abs()).float().mean()))


def lm_serve_run(tag, cfg, device, consistency_len, why=""):
    """One model at full width: weights from a seeded generator on the card,
    ``serve`` twice (equal tokens, finite logits, the final position), a
    profile of 10 decode steps and the numbers of the phase's lines; then
    the teacher-forced check at ``consistency_len`` in bf16 (within
    LM_TF_BF16_TOL) and on the same weights upcast to f32 (within
    LM_TF_TOL), and the bf16 decode step against the f32 prefill (as
    close as the bf16 prefill, LM_BF16_DECODE_RATIO).  Frees its
    weights."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    b, L, gen = LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_mod.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[lm] {tag}: {cfg.arch_id}, {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {sum(p.numel() for p in model.parameters())} params "
        f"({cfg.param_count()} by the config), {wbytes / 1e9:.2f} GB "
        f"{cfg.param_dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s{why}")
    runs = [serve.serve(cfg, batch=b, prompt_len=L, gen=gen, seed=0,
                        device=device, model=model) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    res = runs[1]
    finite = all(bool(torch.isfinite(lg).all()) for r in runs
                 for lg in r.logits)
    same = torch.equal(runs[0].tokens, runs[1].tokens)
    bits = all(torch.equal(x, y) for x, y in zip(runs[0].logits,
                                                 runs[1].logits))
    steps = res.decode_ms
    p50 = statistics.median(steps)
    p99 = statistics.quantiles(steps, n=100)[98]
    pos_end = L + gen - 1
    log(f"[lm] {tag}: serve B {b}, prompt {L}, gen {gen}: prefill "
        f"{res.prefill_ms:.2f} ms ({b * L / res.prefill_ms * 1e3:.0f} tok/s; "
        f"first run {runs[0].prefill_ms:.2f} ms), decode {len(steps)} steps "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
        f"{b * len(steps) / sum(steps) * 1e3:.0f} tok/s aggregate (first run "
        f"p50 {statistics.median(runs[0].decode_ms):.3f} ms); logits finite "
        f"{finite}, final pos {res.pos} (prompt + gen - 1 = {pos_end}), "
        f"tokens equal over two runs {same}, logits bit-equal {bits}")
    if not finite or res.pos != pos_end or not same:
        raise AssertionError(f"{tag}: serve gates failed")
    del runs, res

    p0 = L + gen // 2
    logits, state = make_prefill_step(cfg, L + gen)(
        model, serve.make_batch(cfg, b, L, torch.Generator().manual_seed(1),
                                device))
    tok = torch.argmax(logits, -1)[:, None]
    decode = make_decode_step(cfg)

    def decode_at_p0():
        state["pos"] = p0
        decode(model, tok, state)
    wall, busy_ms, kernels = profile_steps(
        f"LM {tag} decode step (B {b}, pos {p0})", decode_at_p0,
        LM_PROFILE_STEPS, "step")
    nbytes = lm_step_bytes(model, cfg, b, p0)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    log(f"[lm] {tag}: decode step bound {nbytes / 1e9:.3f} GB at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms:.3f} ms (p50 "
        f"{p50:.3f} ms, {bound_ms / p50:.1%} of it); {kernels:.0f} kernel "
        f"launches a step, device busy {busy_ms:.3f} ms a step "
        f"({busy_ms / wall / 1e3:.1%} of the unprofiled wall); peak device "
        f"memory serving {peak / 2**30:.2f} GiB, weights "
        f"{wbytes / 2**30:.2f} GiB")
    del logits, state

    full16, step16 = lm_teacher_forced(cfg, model, b, consistency_len,
                                       device)
    model = model.float()
    full32, step32 = lm_teacher_forced(
        dataclasses.replace(cfg, param_dtype="float32",
                            compute_dtype="float32"),
        model, b, consistency_len, device)
    scale = max(1.0, float(full32.abs().max()))
    gaps = {"bf16": lm_gap(step16, full16), "f32": lm_gap(step32, full32)}
    for name, (dmax, dmean, outside) in gaps.items():
        log(f"[lm] {tag}: teacher-forced prefill {consistency_len - 1} + 1 "
            f"step vs prefill {consistency_len}, {name}: max |d logits| "
            f"{dmax:.3e}, mean {dmean:.3e} (|logits| <= {scale:.3f}); "
            f"outside rtol = atol = 2e-2: {outside:.2%}")
    err_full, err_step = lm_gap(full16, full32)[1], lm_gap(step16, full32)[1]
    log(f"[lm] {tag}: bf16 against the f32 prefill on the same weights, "
        f"mean |d logits|: prefill {err_full:.3e}, decode step "
        f"{err_step:.3e} (ratio {err_step / max(err_full, 1e-30):.3f})")
    if gaps["f32"][0] > LM_TF_TOL * scale:
        raise AssertionError(f"{tag}: decode disagrees with prefill in f32")
    if gaps["bf16"][0] > LM_TF_BF16_TOL * scale \
            or gaps["bf16"][1] > LM_TF_BF16_TOL:
        raise AssertionError(f"{tag}: decode disagrees with prefill in bf16")
    if err_step > LM_BF16_DECODE_RATIO * err_full:
        raise AssertionError(f"{tag}: the bf16 decode step is further from "
                             f"f32 than the bf16 prefill")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm(device):
    """The LM stack's serving path: the twin check (every SMOKE config and
    llama3.2-3b at full width, depth 2, card against CPU in f32), then L1
    (llama3.2-3b, all of it) and L2 (jamba-v0.1-52b at full width, one
    superblock) through ``serve`` at B 8, prompt 512, gen 32."""
    from repro_torch.configs import ARCH_IDS, get_config
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        lm_twin(arch + " SMOKE", cfg, 2, 32, 4, device)
    llama = get_config("llama3.2-3b")
    lm_twin("llama3.2-3b at full width, depth 2",
            dataclasses.replace(llama, num_layers=2, param_dtype="float32",
                                compute_dtype="float32"), 2, 16, 4, device)
    log(f"[lm] twin checks {time.perf_counter() - t0:.1f} s")
    lm_serve_run("L1", llama, device, LM_SERVE["prompt_len"])
    jamba = get_config("jamba-v0.1-52b")
    l2 = dataclasses.replace(jamba, num_layers=jamba.superblock_period())
    lm_serve_run("L2", l2, device, 256, why=(
        f"; depth cut {jamba.num_layers} -> {l2.num_layers} layers (one "
        f"superblock: 1 attention + 7 Mamba2, 4 MoE + 4 MLP): all "
        f"{jamba.param_count() / 1e9:.1f}e9 params in bf16 are "
        f"{2 * jamba.param_count() / 1e9:.0f} GB, over the card's 80 GB"))
    log(f"[lm] phase {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ train
TRAIN_TWIN_LR = 1e-2                # train: the twin check's peak rate
TRAIN_TWIN_LOSS_TOL = 1e-5          # card vs CPU, f32, TF32 off: relative
TRAIN_TWIN_GRAD_TOL = 1e-4          # ... each leaf, relative to max|g_leaf|
# ... a step's weights are held within 1e-3·lr where |g| > this share of
# max|g_leaf|: a first step is lr·g/(|g| + eps) of either optimizer, whose
# sign and size are noise where |g| is near the gradient bar or eps
TRAIN_TWIN_SURE = 1e-2
# T1 runs the first six steps of a run on the stack's default schedule
# (TrainStepConfig: peak 3e-4, 100 warm-up steps, 10 000 in all).  At
# peak 3e-4 with one warm-up step the loss rose 12.49 -> 17.76 on an
# H100, and the reference's rises alike (tests/witness_lm_train_rate.py)
TRAIN_T1 = dict(batch=4, seq=2048, steps=6, q_chunk=1024)
TRAIN_T2 = dict(batch=8, seq=2048, steps=12, ckpt_every=4, fault_at=10,
                timed=5)
TRAIN_T3 = dict(batch=4, seq=2048, steps=3, rows=8, log2_cols=20,
                top_k=10_000, momentum=0.9)
H100_BF16_PER_S = 989e12            # H100 SXM dense bf16, NVIDIA data sheet


def train_batch(cfg, batch, seq, key_seed, device):
    """Zipf tokens from ``prng.key(key_seed)`` and, by family, stub patch or
    frame embeddings from a CPU generator, on ``device``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.data.synthetic import zipf_token_stream
    out = zipf_token_stream(prng.key(key_seed, device), batch, seq,
                            cfg.vocab_size)
    gen = torch.Generator().manual_seed(key_seed)
    if cfg.frontend == "vision":
        out["patch_embeds"] = (0.02 * torch.randn(
            (batch, cfg.num_prefix, cfg.d_model), generator=gen)
        ).to(device, cfg.pdtype)
    if cfg.encoder_layers:
        out["src_embeds"] = (0.02 * torch.randn(
            (batch, seq, cfg.d_model), generator=gen)).to(device, cfg.pdtype)
    return out


def _grads_of(cfg, model, batch, q_chunk):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    from repro_torch.models import model as model_mod
    total, _ = model_mod.forward_train(cfg, model, batch, q_chunk=q_chunk)
    total.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def train_twin(tag, cfg, batch, seq, device, with_step):
    """The same weights (drawn on the CPU) and batch on the CPU and on the
    card, f32, TF32 off: the loss within TRAIN_TWIN_LOSS_TOL relative and
    each gradient leaf within TRAIN_TWIN_GRAD_TOL·max|g_leaf|; with
    ``with_step``, one full train step under AdamW and one under
    Adafactor: the updated weights within 1e-3·lr where |g| exceeds
    TRAIN_TWIN_SURE·max|g_leaf|, and within 2·lr everywhere (a first step
    of either optimizer is about lr·sign(g)), and the optimizer
    statistics within TRAIN_TWIN_GRAD_TOL·max|leaf|.  Returns the worst
    ratios."""
    import copy
    import torch
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps

    base = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    b_cpu = train_batch(cfg, batch, seq, 0, "cpu")
    q_chunk = 1024
    runs = {}
    for dev in ("cpu", device):
        model = copy.deepcopy(base).to(dev)
        runs[dev] = _grads_of(cfg, model, {k: v.to(dev) for k, v in
                                           b_cpu.items()}, q_chunk)
        del model
    (l_cpu, g_cpu), (l_dev, g_dev) = runs["cpu"], runs[device]
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    errs = {n: float((g_dev[n] - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for n, g in g_cpu.items()}
    worst_leaf = max(errs, key=errs.get)
    grad_err = errs[worst_leaf]
    log(f"[train] twin {tag}: card vs CPU, f32, B {batch} x S {seq}: loss "
        f"{l_cpu:.6f}, |d loss|/loss {loss_err:.3e}, max |d g|/max|g| over "
        f"leaves {grad_err:.3e} ({worst_leaf})")
    if loss_err > TRAIN_TWIN_LOSS_TOL or grad_err > TRAIN_TWIN_GRAD_TOL:
        raise AssertionError(f"[train] twin {tag}: the card's loss or "
                             f"gradients differ from the CPU's")
    worst = {"loss": loss_err, "grad": grad_err}
    if with_step:
        for opt in ("adamw", "adafactor"):
            tcfg = steps.TrainStepConfig(optimizer=opt, peak_lr=TRAIN_TWIN_LR,
                                         warmup_steps=1, total_steps=2,
                                         q_chunk=q_chunk)
            after = {}
            for dev in ("cpu", device):
                model = copy.deepcopy(base).to(dev).requires_grad_(True)
                st = {"model": model, "opt": steps.init_optimizer(
                    cfg, tcfg, model), "step": 0}
                st, _ = steps.make_train_step(cfg, tcfg)(
                    st, {k: v.to(dev) for k, v in b_cpu.items()})
                stats = st["opt"][1:3]
                after[dev] = (
                    {n: p.detach().cpu() for n, p in model.named_parameters()},
                    [{n: t.cpu() for n, t in d.items()} for d in stats])
            (p_cpu, s_cpu), (p_dev, s_dev) = after["cpu"], after[device]
            for n, p in p_cpu.items():
                d = (p_dev[n] - p).abs()
                g = g_cpu[n].abs()
                sure = g > TRAIN_TWIN_SURE * float(g.max())
                if bool((d[sure] > 1e-3 * TRAIN_TWIN_LR).any()) \
                        or float(d.max()) > 2 * TRAIN_TWIN_LR:
                    raise AssertionError(
                        f"[train] twin {tag} {opt}: weight {n} differs: "
                        f"max {float(d.max()):.3e}, where |g| is above the "
                        f"bar {float(d[sure].max()):.3e} (lr "
                        f"{TRAIN_TWIN_LR})")
            st_err = max(float((b[n] - a[n]).abs().max())
                         / max(float(a[n].abs().max()), 1e-30)
                         for a, b in zip(s_cpu, s_dev) for n in a)
            worst[opt + "_state"] = st_err
            if st_err > TRAIN_TWIN_GRAD_TOL:
                raise AssertionError(f"[train] twin {tag} {opt}: optimizer "
                                     f"state differs ({st_err:.3e})")
    if with_step:
        log(f"[train] twin {tag}: one step each, weights held, optimizer "
            f"statistics max |d|/max|leaf|: " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items()
                if k.endswith("_state")))
    return worst


def train_t1(device):
    """T1: llama3.2-3b whole (bf16, AdamW, remat "nothing"), B 4 x S 2048
    zipf tokens, 6 steps, twice from the same seed: finite, falling,
    equal loss bits; step time, tokens/s, the 6·N·tokens share of the
    bf16 peak, a profiled step, the AdamW update against its bytes
    bound, peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import steps

    cfg = get_config("llama3.2-3b")
    b, seq, n_steps = TRAIN_T1["batch"], TRAIN_T1["seq"], TRAIN_T1["steps"]
    tcfg = steps.TrainStepConfig(optimizer="adamw",
                                 q_chunk=TRAIN_T1["q_chunk"], remat=True,
                                 remat_policy="nothing")
    batches = [train_batch(cfg, b, seq, 1000 + i, device)
               for i in range(n_steps)]
    step_fn = steps.make_train_step(cfg, tcfg)

    def one_run():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = steps.init_train_state(
            cfg, tcfg, torch.Generator(device=device).manual_seed(0),
            device=device)
        losses, ms = [], []
        for batch in batches:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            st, m = step_fn(st, batch)
            e1.record()
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        return st, losses, ms, torch.cuda.max_memory_allocated()

    st, losses1, ms1, peak1 = one_run()
    del st
    st, losses2, ms2, peak2 = one_run()
    n_params = sum(p.numel() for p in st["model"].parameters())
    p50 = statistics.median(ms2[1:])
    tokens = b * seq
    share = 6 * n_params * tokens / (p50 * 1e-3 * H100_BF16_PER_S)
    finite = all(math.isfinite(v) for v in losses1 + losses2)
    log(f"[train] T1 llama3.2-3b: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {n_params} params bf16, AdamW (peak "
        f"{tcfg.peak_lr}, {tcfg.warmup_steps} warm-up steps of "
        f"{tcfg.total_steps}), remat nothing, B "
        f"{b} x S {seq} ({tokens} tokens a step), {n_steps} steps: losses "
        f"{[round(v, 5) for v in losses2]}; step ms {[round(v, 2) for v in ms2]}"
        f" (run 1 {[round(v, 2) for v in ms1]}); p50 over steps 2-{n_steps} "
        f"{p50:.2f} ms, {tokens / p50 * 1e3:.0f} tokens/s, 6*N*tokens / "
        f"(step x {H100_BF16_PER_S / 1e12:.0f} TFLOP/s bf16) = {share:.1%}; "
        f"peak device memory {peak2 / 2**30:.2f} GiB (run 1 "
        f"{peak1 / 2**30:.2f}); finite {finite}, falling "
        f"{losses2[-1] < losses2[0]}, equal loss bits over two runs "
        f"{losses1 == losses2}")
    if not finite or not losses2[-1] < losses2[0] or losses1 != losses2:
        raise AssertionError("[train] T1: loss gates failed")
    holder = [st]

    def step_once():
        holder[0], _ = step_fn(holder[0], batches[0])
    wall, busy_ms, kernels = profile_steps("train T1 step", step_once, 1,
                                           "step")
    log(f"[train] T1: a step {kernels:.0f} kernel launches, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall / 1e3:.1%} of the unprofiled "
        f"wall {wall * 1e3:.2f} ms)")
    st = holder[0]
    params = dict(st["model"].named_parameters())
    grads = {n: torch.full_like(p, 1e-3) for n, p in params.items()}
    ocfg = AdamWConfig(lr=1e-6)
    upd_ms = time_cuda(lambda: adamw_update(grads, st["opt"], params, ocfg),
                       3, warmup=1)
    nbytes = sum(p.numel() * (2 * p.element_size() + grads[n].element_size()
                              + 16) for n, p in params.items())
    bound = nbytes / H100_BYTES_PER_S * 1e3
    log(f"[train] T1: AdamW update {upd_ms:.2f} ms (CUDA events, 3 calls) "
        f"against its bytes bound {nbytes / 1e9:.2f} GB (params read and "
        f"written, grads read, f32 m and v read and written) at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s = {bound:.2f} ms "
        f"({bound / upd_ms:.1%})")
    del st, holder, params, grads
    gc.collect()
    torch.cuda.empty_cache()


class _Fault(RuntimeError):
    pass


def train_t2(device):
    """T2: mamba2-130m whole through ``Trainer`` (Adafactor, B 8 x S 2048,
    checkpoints every 4 steps, the activation monitor): a fault before
    step 10, the restart from step 8, an uninterrupted 12-step run; the
    step-12 loss, weights and optimizer state equal bit for bit; the
    monitor's heavy hitters found, K7 once an observe, K8 once a
    report."""
    import tempfile
    import torch
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.train import steps
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           load_state_tree, state_tree)

    cfg = get_config("mamba2-130m")
    b, seq, n_steps = TRAIN_T2["batch"], TRAIN_T2["seq"], TRAIN_T2["steps"]
    every, fault_at = TRAIN_T2["ckpt_every"], TRAIN_T2["fault_at"]
    tcfg = steps.TrainStepConfig(optimizer="adafactor", peak_lr=1e-3,
                                 warmup_steps=2, total_steps=n_steps)

    def batch_fn(step):
        return train_batch(cfg, b, seq, 2000 + step, device)

    def bomb(step):
        if step == fault_at:
            raise _Fault(step)

    def observes(start, stop):
        return sum(1 for s in range(start + 1, stop + 1) if s % every == 0)

    k7, k8 = "sketch_update_table", "sketch_estimate_table"
    with tempfile.TemporaryDirectory() as tmp:
        def rc(name, ckpt_every):
            return TrainerConfig(total_steps=n_steps, ckpt_every=ckpt_every,
                                 ckpt_dir=f"{tmp}/{name}", log_every=every,
                                 monitor_activations=True)

        def faulted():
            try:
                Trainer(cfg, tcfg, rc("run", every), batch_fn, bomb,
                        device=device).run()
            except _Fault:
                return True
            return False
        died, _ = counted("T2:fault", {k7: observes(0, fault_at)}, faulted)
        t0 = time.perf_counter()
        tr_b = Trainer(cfg, tcfg, rc("run", every), batch_fn, device=device)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
        start = tr_b.start_step
        out_b, _ = counted("T2:resume", {k7: observes(start, n_steps),
                                         k8: 1}, tr_b.run)
        torch.cuda.reset_peak_memory_stats()
        tr_c = Trainer(cfg, tcfg, rc("oracle", n_steps), batch_fn,
                       device=device)
        out_c, wall_c = counted("T2:oracle", {k7: observes(0, n_steps),
                                              k8: 1}, tr_c.run)
        peak_c = torch.cuda.max_memory_allocated()
        loss_b = [m for m in out_b["metrics"] if m["step"] == n_steps][0]
        loss_c = [m for m in out_c["metrics"] if m["step"] == n_steps][0]
        tb, tc = state_tree(tr_b.state), state_tree(tr_c.state)
        same_params = all(torch.equal(tb["params"][n], t)
                          for n, t in tc["params"].items())
        same_opt = all(torch.equal(tb["opt"][f][n], t)
                       for f in (1, 2) for n, t in tc["opt"][f].items())
        rep_b, rep_c = out_b["activation_report"], out_c["activation_report"]
        # step time and checkpoint costs, after the gates
        st = tr_c.state
        ms = []
        for i in range(TRAIN_T2["timed"]):
            batch = batch_fn(i)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            st, _ = tr_c.step_fn(st, batch)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        holder = [st]

        def step_once():
            holder[0], _ = tr_c.step_fn(holder[0], batch_fn(0))
        wall, busy_ms, kernels = profile_steps("train T2 step", step_once, 1,
                                               "step")
        st = holder[0]
        t0 = time.perf_counter()
        save_checkpoint(f"{tmp}/timed", n_steps, state_tree(st))
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = load_state_tree(st, restore_checkpoint(f"{tmp}/timed", n_steps,
                                                    state_tree(st)))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    p50 = statistics.median(ms)
    n_params = sum(p.numel() for p in st["model"].parameters())
    log(f"[train] T2 mamba2-130m via Trainer: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {n_params} params {cfg.param_dtype}, Adafactor, B "
        f"{b} x S {seq}, checkpoints every {every}: fault before step "
        f"{fault_at} raised {died}, restart at step {start} (Trainer built "
        f"and restored in {t_resume:.2f} s), step-{n_steps} loss "
        f"{loss_b['loss']!r} resumed vs {loss_c['loss']!r} uninterrupted, "
        f"weights equal {same_params}, optimizer state equal {same_opt}; "
        f"uninterrupted run {wall_c:.2f} s, peak device memory "
        f"{peak_c / 2**30:.2f} GiB; step p50 {p50:.2f} ms ({ms}), "
        f"{b * seq / p50 * 1e3:.0f} tokens/s; a profiled step {kernels:.0f} "
        f"kernel launches, device busy {busy_ms:.2f} ms ({busy_ms / wall / 1e3:.1%}"
        f" of the unprofiled wall {wall * 1e3:.2f} ms); checkpoint save "
        f"{t_save:.3f} s, restore {t_restore:.3f} s; monitor: hh_count "
        f"{rep_c['hh_count']} (resumed {rep_b['hh_count']}), top1 share "
        f"{rep_c['hh_top1_frac']:.4f}, tokens seen {rep_c['tokens_seen']}; "
        f"launches {PATH_LAUNCHES['T2:fault']}, "
        f"{PATH_LAUNCHES['T2:resume']}, {PATH_LAUNCHES['T2:oracle']}")
    if not (died and start == fault_at - fault_at % every
            and loss_b["loss"] == loss_c["loss"] and same_params
            and same_opt and rep_b["hh_count"] > 0 and rep_c["hh_count"] > 0):
        raise AssertionError("[train] T2: resume or monitor gates failed")
    del tr_b, tr_c, st
    gc.collect()
    torch.cuda.empty_cache()


def train_t3(device):
    """T3: tinyllama-1.1b whole (bf16) with Count-Sketch compressed
    gradients (R 8, C 2^20, top_k 10 000, momentum 0.9), then AdamW, B 4 x
    S 2048, 3 steps.  Returns the K7 and K8 rows at these shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import sketch
    from repro_torch.models import model as model_mod
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim import sketch_compress as sc

    cfg = get_config("tinyllama-1.1b")
    b, seq, n_steps = TRAIN_T3["batch"], TRAIN_T3["seq"], TRAIN_T3["steps"]
    ccfg = sc.SketchCompressConfig(rows=TRAIN_T3["rows"],
                                   log2_cols=TRAIN_T3["log2_cols"],
                                   top_k=TRAIN_T3["top_k"],
                                   momentum=TRAIN_T3["momentum"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_mod.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    cstate = sc.sketch_compress_init(params, ccfg)
    ostate, ocfg = adamw_init(params), AdamWConfig(lr=3e-4)
    n = cstate.error.numel()
    chunk = sketch.TENSOR_CHUNK
    n_chunks = -(-n // chunk)
    k7, k8 = "sketch_update_table", "sketch_estimate_table"
    rows = None
    for step in range(n_steps):
        batch = train_batch(cfg, b, seq, 3000 + step, device)
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        total, _ = model_mod.forward_train(cfg, model, batch)
        total.backward()
        torch.cuda.synchronize()
        t_grad = time.perf_counter() - t0
        grads = {nm: p.grad for nm, p in params.items()}

        def compress():
            t0 = time.perf_counter()
            sk = sc.local_sketch(grads, cstate, ccfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = sc.decompress(sk, grads, cstate, ccfg)
            torch.cuda.synchronize()
            return sk, out, t1 - t0, time.perf_counter() - t1
        prev_err, prev_mom = cstate.error.clone(), cstate.momentum.clone()
        (sk, (upd, cstate, density), t_sk, t_dec), _ = counted(
            f"T3:{step + 1}", {k7: n_chunks, k8: n_chunks}, compress)
        # what decompress had to find: the merged sketch's estimate (K8,
        # outside the counted run; the same bits), momentum, then corrected
        t0 = time.perf_counter()
        est = sketch.tensor_sketch_estimate(sk, n)
        torch.cuda.synchronize()
        t_est = time.perf_counter() - t0
        corrected = prev_mom * ccfg.momentum + est
        corrected += prev_err
        del est, prev_err, prev_mom
        mag = corrected.abs()
        thresh = float(torch.topk(mag, ccfg.top_k)[0][-1])
        keep = mag >= max(thresh, 1e-30)
        kept = int(keep.sum())
        n_above = int((mag > thresh).sum())
        n_at = int((mag == thresh).sum())
        del mag
        sent = sc._flatten(upd, cstate.sizes)
        sent_ok = torch.equal(
            sent, torch.where(keep, corrected, 0.0).to(torch.bfloat16).float())
        del sent
        err_ok = torch.equal(cstate.error, torch.where(keep, 0.0, corrected))
        ef = float((cstate.error + torch.where(keep, corrected, 0.0)
                    - corrected).abs().max())
        dens_ok = round(float(density) * n) == kept
        log(f"[train] T3 step {step + 1}: loss {float(total.detach()):.5f}; "
            f"grads "
            f"{t_grad * 1e3:.1f} ms; compression of {n} coordinates in "
            f"{n_chunks} chunks of {chunk}: sketch {t_sk * 1e3:.1f} ms, "
            f"decompress {t_dec * 1e3:.1f} ms (the estimate alone "
            f"{t_est * 1e3:.1f} ms, so top-k and the rest "
            f"{(t_dec - t_est) * 1e3:.1f} ms); threshold {thresh:.6e}: "
            f"{n_above} above, {n_at} at it; kept {kept} = top_k "
            f"{ccfg.top_k} + {kept - ccfg.top_k} ties at the threshold; "
            f"density {float(density):.4e} (== kept/n: {dens_ok}); sent == "
            f"corrected on the kept set (bf16) {sent_ok}; error == corrected "
            f"off it {err_ok}; error-feedback identity max |err + sent - "
            f"(momentum + prev_err + est)| {ef:.3e}; launches "
            f"{PATH_LAUNCHES[f'T3:{step + 1}']}")
        if not (n_above < ccfg.top_k <= kept == n_above + n_at and sent_ok
                and err_ok and dens_ok and ef == 0.0):
            raise AssertionError(f"[train] T3 step {step + 1}: the top-k "
                                 f"selection or error feedback is wrong")
        if step == 0:
            rows = t3_kernel_rows(device, sc._flatten(grads, cstate.sizes),
                                  sk, chunk)
        del corrected, keep
        adamw_update(upd, ostate, params, ocfg)
        del upd, grads
        model.zero_grad(set_to_none=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] T3: peak device memory {peak:.2f} GiB (weights, grads, "
        f"AdamW m and v, error and momentum of {n} coordinates, and the "
        f"gates' copies)")
    del model, params, cstate, ostate
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def t3_kernel_rows(device, flat, sk, chunk):
    """K7's step-1 table against the float64 plain version over all
    coordinates (within 1e-5·max|table|), K7 timed on one chunk of
    ``chunk`` coordinates against its plain version, the library call
    and the bound; then K8 on the first chunk's keys (0, j) against its
    plain version by int32 view and timed the same way (:func:`k8_row`)."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import sketch_update as su

    hp, l2c, r = sk.params, sk.log2_cols, sk.rows
    n = flat.numel()
    t64 = torch.zeros(sk.table.shape, dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        lo = torch.arange(s, min(n, s + chunk), device=device)
        su.sketch_update_torch(t64, hp, torch.zeros_like(lo), lo,
                               flat[s:s + chunk].double())
    scale = float(t64.abs().max())
    err7 = float((sk.table.double() - t64).abs().max())
    lo = torch.arange(chunk, device=device)
    hi = torch.zeros_like(lo)
    vals = flat[:chunk].contiguous()
    qb, qs = hashing.hashes(hp, hi, lo, l2c)
    log(f"[train] T3 K7: step 1's table (R {r}, C 2^{l2c}, {n} weighted "
        f"coordinates) vs the float64 plain version: max |d| {err7:.3e} "
        f"(max |table| {scale:.3e}, bar 1e-5 of it)")
    if err7 > 1e-5 * scale:
        raise AssertionError("[train] T3: K7 disagrees with its plain "
                             "version")
    table = torch.zeros_like(sk.table)
    flat_idx = ((torch.arange(r, device=device) << l2c)[:, None] | qb
                ).reshape(-1)
    signed = (qs.float() * vals[None, :]).reshape(-1)
    k7 = timings({"ms": lambda: su.sketch_update_cuda(table, hp, hi, lo,
                                                      vals),
                  "plain_ms": lambda: su.sketch_update_torch(table, hp, hi,
                                                             lo, vals),
                  "library_ms": lambda: table.view(-1).index_add_(
                      0, flat_idx, signed)}, 5)
    cells = int(torch.unique(flat_idx).numel())
    nbytes = chunk * (8 + 8 + 4) + cells * 8
    k7["bound_ms"], k7["bound_by"] = op_bound_ms(nbytes)
    k7["max_abs_err"] = err7
    adds = r * chunk
    log_row("sketch_update_table train (T3 chunk)", k7,
            f"; {chunk} weighted coordinates, R {r}, C 2^{l2c}, {cells} "
            f"cells touched: {nbytes / 1e6:.2f} MB; {adds} adds, "
            f"{adds / (k7['ms'] * 1e-3) / 1e9:.1f}e9 adds/s (the L2's "
            f"scattered fp32 atomics bound it in practice); timed by "
            f"{k7['timed_by']}")
    del qb, qs, flat_idx, signed, table
    k8 = k8_row("sketch_estimate_table train (T3 chunk)", sk.table, hp,
                None, None, chunk, 5)
    return {"sketch_update_table": k7, "sketch_estimate_table": k8}


def phase_train(device):
    """The LM stack's training path: the twin checks (every SMOKE config
    one forward/backward and one step under each optimizer; llama3.2-3b
    at full width, depth 2, B 1 x S 256, loss and gradients), then T1,
    T2 and T3.  Returns K7's and K8's rows at T3's shapes."""
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        train_twin(arch + " SMOKE", cfg, 2, 32, device, with_step=True)
    llama = get_config("llama3.2-3b")
    train_twin("llama3.2-3b at full width, depth 2",
               dataclasses.replace(llama, num_layers=2,
                                   param_dtype="float32",
                                   compute_dtype="float32"), 1, 256, device,
               with_step=False)
    log(f"[train] twin checks {time.perf_counter() - t0:.1f} s")
    train_t1(device)
    log(f"[train] T1 done at {time.perf_counter() - t0:.1f} s")
    train_t2(device)
    log(f"[train] T2 done at {time.perf_counter() - t0:.1f} s")
    rows = train_t3(device)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------- lm-mesh
LM_MESH_TIMEOUT_S = 600             # lm-mesh: a layout's ranks, at most
LM_MESH_ACT_MODES = ("embed_tp", "seq_tp", "dp_only")
LM_MESH_ADAFACTOR = ("mamba2-130m", "jamba-v0.1-52b")
# (a) a weight whose tiny gradient flips sign moves by 2·lr, plus the f32
# rounding of the weights it is the difference of
LM_MESH_FLIP = 2 * TRAIN_TWIN_LR * (1 + 1e-5)
# (a) every SMOKE config in f32; B 4 so that each data rank has rows
LM_MESH_SMOKE = dict(batch=4, seq=32)
# (b) full width in f32, without remat (the gradients' bits are remat's,
# and the gloo ranks would gather the weights through the host again):
# llama3.2-3b depth 2 at phase train's `train_twin` shape with B 2 (a row
# a data rank); qwen3-moe depth 1, the sequence cut to 128 (its 3.7e9 f32
# weights are 15 GB, as much again in gradients, and the single-device
# twin's copy besides)
LM_MESH_WIDE = (("llama3.2-3b", 2, 2, 256), ("qwen3-moe-235b-a22b", 1, 2,
                                            128))
# (b): ranks sharing a card compute one device's twin together when
# their f32 weights, gradients and blocks take this much, else in turns
LM_MESH_TWINS_TOGETHER_BYTES = 60e9
# (c) M-T1: llama3.2-3b bf16, AdamW, remat, B 4 x S 2048, a warm-up step
# then 3 timed; gloo ranks sharing one card train LM_MESH_T1_GLOO_LAYERS
LM_MESH_T1 = dict(batch=4, seq=2048, steps=3)
LM_MESH_T1_GLOO_LAYERS = 2
# (d) M-T3: tinyllama-1.1b with Count-Sketch gradients on a data-only mesh;
# four replicas on one card train LM_MESH_T3_GLOO_LAYERS of its 22 layers
LM_MESH_T3 = dict(batch=4, seq=2048, steps=2, rows=8, log2_cols=20,
                  top_k=10_000, momentum=0.9, lr=1e-4)
LM_MESH_T3_GLOO_LAYERS = 11
# (e) M-J: jamba-v0.1-52b at full width, one superblock of 8 layers, on
# four cards: a card holds 40 GB of states (its quarter of 13.3e9 bf16
# weights and gradients, f32 AdamW moments), the superblock's weights
# gathered over "data" for its backward (13 GB) and the activations; S
# 2048 uncut (68.27 GiB a card at its peak on an H100 80GB)
LM_MESH_J = dict(batch=4, seq=2048, steps=3, layers=8)
# (g) serving on a mesh.  (g1) every SMOKE config in f32, B 4 (the batch
# over "data", the caches' sequence over "model") and B 1 (the sequence
# over every axis), prefill then 6 decode steps teacher-forced with one
# device's greedy tokens
LM_MESH_SERVE_SMOKE = dict(batches=(4, 1), prompt=32, steps=6)
# (g2) full width in f32: (arch, layers, batch, prompt, decode steps);
# ranks sharing one card hold TP blocks only (no FSDP: each step would
# gather the f32 vocabulary blocks through the host)
LM_MESH_SERVE_WIDE = (("llama3.2-3b", 2, 2, 256, 6),
                      ("qwen3-moe-235b-a22b", 1, 2, 128, 6))
# (g3) M-L1: phase lm's L1 cell on the mesh, bf16, weights cut at the
# draw; (g4) M-LL: one sequence of 8 192, its KV sequence over every
# axis; (g5) on 4 cards, M-L2: L2's cell.  Ranks sharing one card run 2
# layers and gen 3 (every collective is staged through the host: ~3 s a
# decode step, most of it the vocabulary block's two ~394 MB gathers)
LM_MESH_SERVE = {
    "M-L1": dict(arch="llama3.2-3b", layers=None, batch=8, prompt=512,
                 gen=32),
    "M-LL": dict(arch="llama3.2-3b", layers=None, batch=1, prompt=8192,
                 gen=16),
    "M-L2": dict(arch="jamba-v0.1-52b", layers=8, batch=8, prompt=512,
                 gen=32, cards=4)}
LM_MESH_SERVE_GLOO = dict(layers=2, gen=3)


def lm_mesh_plan(device_type="cuda", smoke_only=False):
    """What lm-mesh runs; the CPU rehearsal cuts it to SMOKE shapes."""
    return dict(device_type=device_type, smoke_only=smoke_only,
                smoke=LM_MESH_SMOKE, wide=LM_MESH_WIDE, t1=LM_MESH_T1,
                t1_gloo_layers=LM_MESH_T1_GLOO_LAYERS, t3=LM_MESH_T3,
                t3_gloo_layers=LM_MESH_T3_GLOO_LAYERS, jamba=LM_MESH_J,
                serve_smoke=LM_MESH_SERVE_SMOKE,
                serve_wide=LM_MESH_SERVE_WIDE, serve=LM_MESH_SERVE,
                serve_gloo=LM_MESH_SERVE_GLOO)


def lm_mesh_rank(rank, world, backend, shared, tmp, plan, queue):
    """One rank of phase lm-mesh (a spawned process): puts (rank, "ok",
    its report) or (rank, "error", the traceback) on ``queue``."""
    import traceback
    try:
        queue.put((rank, "ok", _lm_mesh_rank(rank, world, backend, shared,
                                             Path(tmp), plan)))
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


class _RankCtx:
    """A lm-mesh rank's device, meshes and clocks."""

    def __init__(self, rank, world, backend, shared, tmp, plan):
        import torch
        from repro_torch.launch.mesh import make_host_mesh
        self.rank, self.world, self.backend = rank, world, backend
        self.shared, self.tmp, self.plan = shared, tmp, plan
        self.cuda = plan["device_type"] == "cuda"
        if self.cuda:
            self.dev = torch.device("cuda", 0 if shared else rank)
            torch.cuda.set_device(self.dev)
        else:
            self.dev = torch.device("cpu")
        shape = (2, world // 2) if world % 2 == 0 else (1, world)
        self.mesh = make_host_mesh(shape, ("data", "model"), rank=rank,
                                   init_method=f"file://{tmp / 'rendezvous'}",
                                   backend=backend)
        self.dmesh = make_host_mesh((world,), ("data",))

    def sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def barrier(self):
        import torch.distributed as dist
        self.sync()
        dist.barrier()

    def turns(self):
        """Ranks sharing one card take turns (a barrier after each rank's
        turn); ranks with a card each all go at once.  Yields True on this
        rank's turn."""
        if not self.shared:
            yield True
            return
        for r in range(self.world):
            yield r == self.rank
            self.barrier()

    def free(self):
        import torch
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def _lm_mesh_rank(rank, world, backend, shared, tmp, plan):
    """Phase lm-mesh on one rank: (a) the SMOKE twins, (b) the full-width
    twins, (c) M-T1, (d) M-T3, (e) M-J (4 cards), (f) checkpoints, (g)
    serving on the mesh.  Each gate raises here; returns the numbers the
    parent prints and the launches of (d)'s steps."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if shared and plan["device_type"] == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if plan["device_type"] == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t_start = time.perf_counter()
    ctx = _RankCtx(rank, world, backend, shared, tmp, plan)
    rep = {"rank": rank, "secs": {"start": time.perf_counter() - t_start}}
    parts = [("a", lm_mesh_smoke_twins)]
    if not plan["smoke_only"]:
        parts.append(("b", lambda c: [lm_mesh_wide_twin(c, *w)
                                      for w in plan["wide"]]))
    parts += [("c", lm_mesh_t1), ("d", lm_mesh_t3)]
    if world == 4 and not shared:           # a card a rank
        parts.append(("e", lm_mesh_jamba))
    parts += [("f", lm_mesh_ckpt), ("g", lm_mesh_serve)]
    for key, fn in parts:
        t0 = time.perf_counter()
        rep[key] = fn(ctx)
        rep["secs"][key] = time.perf_counter() - t0
        if rank == 0:       # progress, should a later part fail
            log(f"[lm-mesh] {backend}{world} rank 0: ({key}) done in "
                f"{rep['secs'][key]:.1f} s")
    return rep


def _local_batch(batch, mesh):
    from repro_torch.launch import sharding as sh
    specs = sh.batch_pspecs(batch, mesh)
    return {k: sh.local_shard(v, specs[k], mesh) for k, v in batch.items()}


def _leaf_specs(model, mesh, pol):
    """Each parameter's layout on ``mesh`` (axes it lacks replicated)."""
    from repro_torch.launch import sharding as sh
    names = set(mesh.mesh_dim_names)
    return {n: tuple(a if a in names else None
                     for a in sh._leaf_spec(n, p.ndim, pol))
            for n, p in model.named_parameters()}


def _draw(cfg, tp, dev, on_card):
    """The model's weights from seed 0: on the card (a CUDA generator) or
    on the CPU, then moved there."""
    import torch
    from repro_torch.models import model as model_mod
    gdev = dev if on_card else torch.device("cpu")
    model = model_mod.init_params(cfg, torch.Generator(device=gdev
                                                       ).manual_seed(0),
                                  tp=tp, device=gdev)
    return model.to(dev)


def _digest(model) -> float:
    """A float64 digest of a model's weights (the sum of every leaf)."""
    import torch
    with torch.no_grad():
        return float(sum(p.detach().double().sum() for p in
                         model.parameters()))


def _same_draw_everywhere(ctx, digest):
    """Every rank drew the same full weights (their digests, gathered);
    raises otherwise."""
    import torch
    from repro_torch.core import mesh as mesh_mod
    d = torch.tensor([digest], dtype=torch.float64, device=ctx.dev)
    every = mesh_mod.all_gather_dim(d, ctx.dmesh, "data", 0)
    if not bool((every == every[0]).all()):
        raise AssertionError(f"[lm-mesh] the ranks drew other weights from "
                             f"the same seed: {every.tolist()}")


def _sharded_state(ctx, cfg, tcfg, pol):
    """The train state of ``cfg`` drawn on the card from seed 0, each part
    cut to this rank's blocks on ``ctx.mesh`` as it is drawn."""
    import torch
    from repro_torch.train import steps
    return steps.init_train_state(
        cfg, tcfg, torch.Generator(device=ctx.dev).manual_seed(0),
        device=ctx.dev, mesh=ctx.mesh, policy=pol)


def _grads(cfg, model, batch, remat=True, sync=None):
    from repro_torch.models import model as model_mod
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    total, met = model_mod.forward_train(cfg, model, batch, remat=remat)
    total.backward()
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    if sync is not None:
        sync(grads)
    model.zero_grad(set_to_none=True)
    return float(total.detach()), {k: float(v.detach())
                                   for k, v in met.items()}, \
        grads


def lm_mesh_twin(ctx, cfg, batch, act_mode, optimizer, on_card,
                 with_step=True, remat=True):
    """One sharded forward/backward (and, ``with_step``, train step) of
    ``cfg`` on ``ctx.mesh`` held to one device's on the same card from the
    same weights: the loss within TRAIN_TWIN_LOSS_TOL relative, each
    gradient block within TRAIN_TWIN_GRAD_TOL·max|g_leaf|, the updated
    weights within 1e-3·lr where |g| > TRAIN_TWIN_SURE·max|g_leaf| and
    LM_MESH_FLIP everywhere, an MoE model's dropped share exactly.
    Returns the worst ratios."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.train import steps

    mesh, tp = ctx.mesh, tp_size(ctx.mesh)
    pol = sh.ShardingPolicy(act_mode=act_mode)
    tcfg = steps.TrainStepConfig(optimizer=optimizer, peak_lr=TRAIN_TWIN_LR,
                                 warmup_steps=1, total_steps=2)
    single, model = None, None
    # one device's run, then the cut; ranks sharing a card take turns
    # where their full-width copies (weights, gradients, blocks) would not
    # fit it together
    t0 = time.perf_counter()
    together = not on_card or ctx.world * 3 * 4 * cfg.param_count() \
        <= LM_MESH_TWINS_TOGETHER_BYTES
    for mine in (True,) if together else ctx.turns():
        if not mine:
            continue
        model = _draw(cfg, tp, ctx.dev, on_card)
        digest = _digest(model)
        specs = _leaf_specs(model, mesh, pol)
        loss, met, grads = _grads(cfg, model, batch, remat=remat)
        blocks = {n: (sh.local_shard(g, specs[n], mesh).cpu(),
                      float(g.abs().max())) for n, g in grads.items()}
        del grads
        after = None
        if with_step:
            st = {"model": model, "opt": steps.init_optimizer(cfg, tcfg,
                                                               model),
                  "step": 0}
            st, _ = steps.make_train_step(cfg, tcfg)(st, batch)
            after = {n: sh.local_shard(p.detach(), specs[n], mesh).cpu()
                     for n, p in model.named_parameters()}
            del st, model
            ctx.free()
            model = _draw(cfg, tp, ctx.dev, on_card)
        sh.shard_model(model, mesh, pol)
        ctx.free()
        single = (loss, met, blocks, after, specs)
    _same_draw_everywhere(ctx, digest)
    single_s = time.perf_counter() - t0
    loss, met, blocks, after, specs = single
    local = _local_batch(batch, mesh)
    s_loss, s_met, s_grads = _grads(
        cfg, model, local, remat=remat,
        sync=lambda g: steps.sync_grads(g, model.specs, mesh))
    worst = {"loss": abs(s_loss - loss) / abs(loss), "grad": 0.0,
             "grad_leaf": "", "single_s": single_s}
    for n, g in s_grads.items():
        want, scale = blocks[n]
        e = float((g.float() - want.to(g.device).float()).abs().max()) \
            / max(scale, 1e-30)
        if e >= worst["grad"]:
            worst["grad"], worst["grad_leaf"] = e, n
    del s_grads
    if "dropped_frac" in met and s_met["dropped_frac"] != \
            met["dropped_frac"]:
        raise AssertionError(f"[lm-mesh] {cfg.arch_id}: dropped share "
                             f"{s_met['dropped_frac']!r} on the mesh, "
                             f"{met['dropped_frac']!r} on one device")
    worst["dropped"] = met.get("dropped_frac")
    if worst["loss"] > TRAIN_TWIN_LOSS_TOL \
            or worst["grad"] > TRAIN_TWIN_GRAD_TOL:
        raise AssertionError(f"[lm-mesh] {cfg.arch_id} {act_mode}: loss "
                             f"{worst['loss']:.3e} or gradient "
                             f"{worst['grad']:.3e} "
                             f"({worst['grad_leaf']}) off one device's")
    if with_step:
        st = {"model": model, "opt": steps.init_optimizer(cfg, tcfg,
                                                           model),
              "step": 0}
        st, _ = steps.make_train_step(cfg, tcfg)(st, local)
        w = 0.0
        for n, p in model.named_parameters():
            d = (p.detach().float() - after[n].to(p.device).float()
                 ).abs()
            g = blocks[n][0].to(p.device).float().abs()
            scale = blocks[n][1]
            sure = g > TRAIN_TWIN_SURE * scale
            bad = float(d[sure].max()) if bool(sure.any()) else 0.0
            if bad > 1e-3 * TRAIN_TWIN_LR or float(d.max()) > \
                    LM_MESH_FLIP:
                raise AssertionError(
                    f"[lm-mesh] {cfg.arch_id} {optimizer}: weight {n} "
                    f"{bad:.3e} off where |g| is sure, {float(d.max()):.3e}"
                    f" at most (lr {TRAIN_TWIN_LR})")
            w = max(w, bad / TRAIN_TWIN_LR)
        worst["step"] = w
        del st
    del model
    ctx.free()
    return worst


def lm_mesh_smoke_twins(ctx):
    """(a): every SMOKE config in f32 under AdamW (and Adafactor on
    mamba2-130m and jamba), the act modes in turn."""
    from repro_torch.configs import ARCH_IDS, get_config
    out = {}
    sm = ctx.plan["smoke"]
    for i, arch in enumerate(ARCH_IDS):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        batch = train_batch(cfg, sm["batch"], sm["seq"], 0, ctx.dev)
        act = LM_MESH_ACT_MODES[i % len(LM_MESH_ACT_MODES)]
        for opt in ("adamw",) + (("adafactor",) if arch in LM_MESH_ADAFACTOR
                                 else ()):
            out[f"{arch} {opt} {act}"] = lm_mesh_twin(ctx, cfg, batch, act,
                                                      opt, on_card=False)
    return out


def lm_mesh_wide_twin(ctx, arch, layers, batch, seq):
    """(b): ``arch`` at full width and ``layers`` deep in f32, loss and
    gradients (weights drawn on the card)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    b = train_batch(cfg, batch, seq, 0, ctx.dev)
    t0 = time.perf_counter()
    w = lm_mesh_twin(ctx, cfg, b, "embed_tp", "adamw", on_card=True,
                     with_step=False, remat=False)
    w.update(arch=arch, layers=layers, batch=batch, seq=seq,
             secs=time.perf_counter() - t0)
    return w


class CollectiveClock:
    """Times every collective of ``core.mesh`` while open: CUDA events
    around each call on nccl (the compute stream waits on the
    collective), the host's clock on gloo (its calls block), after a
    synchronize of the card (``sync_card``), so that a staged call's
    copy to the host does not also wait out the card work queued before
    it.  Calls moving at least BIG bytes are also summed apart."""

    NAMES = ("all_reduce", "all_gather", "all_gather_dim",
             "reduce_scatter_dim")
    BIG = 64 << 20

    def __init__(self, cuda_events, sync_card=False):
        self.cuda_events, self.sync_card = cuda_events, sync_card
        self.spans, self.host_s, self.calls = [], [], 0

    def __enter__(self):
        from repro_torch.core import mesh as mesh_mod
        self.orig = {n: getattr(mesh_mod, n) for n in self.NAMES}
        for n, fn in self.orig.items():
            setattr(mesh_mod, n, self._wrap(fn))
        return self

    def _wrap(self, fn):
        import torch

        def timed(*a, **k):
            self.calls += 1
            t = a[0] if a and isinstance(a[0], torch.Tensor) else None
            big = t is not None and t.numel() * t.element_size() >= self.BIG
            if self.cuda_events:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.spans.append((e0, e1, big))
                return out
            if self.sync_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.host_s.append((time.perf_counter() - t0, big))
            return out
        return timed

    def __exit__(self, *exc):
        from repro_torch.core import mesh as mesh_mod
        for n, fn in self.orig.items():
            setattr(mesh_mod, n, fn)

    def ms(self, big_only=False):
        import torch
        if self.cuda_events:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b, big in self.spans
                       if big or not big_only)
        return sum(t for t, big in self.host_s if big or not big_only) * 1e3

    def big_calls(self):
        return sum(1 for *_, big in (self.spans or self.host_s) if big)


def _peak(ctx):
    import torch
    if not ctx.cuda:
        return None, None
    return (torch.cuda.max_memory_allocated(ctx.dev) / 2**30,
            torch.cuda.max_memory_reserved(ctx.dev) / 2**30)


def _reset_peak(ctx):
    import torch
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.dev)


def _timed_steps(ctx, step_fn, state, batches, nccl):
    """Each step's ms (CUDA events, or the host's clock), its collectives'
    ms, and those of its calls of CollectiveClock.BIG bytes or more
    (count, ms)."""
    import torch
    ms, coll, big, losses = [], [], [], []
    for b in batches:
        with CollectiveClock(nccl, sync_card=ctx.cuda) as clock:
            ctx.sync()
            if ctx.cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            if ctx.cuda:
                e1.record()
            ctx.sync()
            ms.append(e0.elapsed_time(e1) if ctx.cuda
                      else (time.perf_counter() - t0) * 1e3)
            coll.append(clock.ms())
            big.append((clock.big_calls(), clock.ms(big_only=True)))
        losses.append(float(m["loss"]))
    return state, ms, coll, big, losses


def lm_mesh_t1(ctx):
    """(c) M-T1: llama3.2-3b at full width (depth cut on ranks sharing a
    card), bf16, AdamW, remat, B 4 x S 2048 over the mesh: the first step
    twice from the same draw (equal loss bits), then 3 timed steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.train import steps

    p = ctx.plan["t1"]
    cfg = get_config("llama3.2-3b", smoke=ctx.plan["smoke_only"])
    if ctx.shared and not ctx.plan["smoke_only"]:
        cfg = dataclasses.replace(cfg,
                                  num_layers=ctx.plan["t1_gloo_layers"])
    seq = p["seq"] if not ctx.plan["smoke_only"] else 64
    tcfg = steps.TrainStepConfig(optimizer="adamw", remat=True,
                                 q_chunk=min(1024, seq))
    pol = sh.ShardingPolicy(act_mode="embed_tp")
    mesh = ctx.mesh
    batches = [_local_batch(train_batch(cfg, p["batch"], seq, 4000 + i,
                                        ctx.dev), mesh)
               for i in range(p["steps"] + 1)]
    step_fn = steps.make_train_step(cfg, tcfg)
    firsts = []
    for run in range(2):
        state = _sharded_state(ctx, cfg, tcfg, pol)
        _reset_peak(ctx)
        state, ms0, _, _, l0 = _timed_steps(ctx, step_fn, state, batches[:1],
                                            ctx.backend == "nccl")
        firsts.append(l0[0])
        if run == 0:
            del state
            ctx.free()
    if firsts[0] != firsts[1]:
        raise AssertionError(f"[lm-mesh] M-T1: the first step's loss "
                             f"{firsts[0]!r} then {firsts[1]!r}")
    state, ms, coll, big, losses = _timed_steps(ctx, step_fn, state,
                                                batches[1:],
                                                ctx.backend == "nccl")
    peak, reserved = _peak(ctx)
    n_local = sum(q.numel() for q in state["model"].parameters())
    del state
    ctx.free()
    if not all(math.isfinite(v) for v in losses + firsts):
        raise AssertionError("[lm-mesh] M-T1: a loss is not finite")
    return dict(layers=cfg.num_layers, batch=p["batch"], seq=seq,
                first=firsts[0], losses=losses, ms=ms, coll_ms=coll,
                big=big, warm_ms=ms0[0], peak_gib=peak, reserved_gib=reserved,
                local_params=n_local)


def _int_grads(model, seed, dev):
    """Integer-valued gradients in [-3, 3] of ``model``'s shapes, from a
    generator seeded ``seed``, in the weights' dtype (exact)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {n: torch.randint(-3, 4, p.shape, generator=gen, device=dev
                             ).to(p.dtype)
            for n, p in model.named_parameters()}


def lm_mesh_t3(ctx):
    """(d) M-T3: tinyllama-1.1b (depth cut on ranks sharing a card) with
    Count-Sketch gradients on a data-only mesh of the ranks, through
    ``compress_and_reduce(axis_names=, mesh=)``: each rank sketches its
    share of the global batch's gradient (K7), the tables are
    all-reduced, every rank decompresses the merged table (K8) and
    applies the same update.  Gates: K7 = K8 = ceil(n / TENSOR_CHUNK) a
    step; on the last step's gradients, one more round taken apart
    (sketch, merge, decompress timed each) whose merged table holds the
    same bits on every rank and lies within (W - 1)·2⁻²⁴·Σ_w |table_w|
    of the float64 sum of the ranks' tables; on integer-valued gradients
    the merged table equals one device's sketch of the summed gradient
    bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core import sketch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as model_mod
    from repro_torch.optim import sketch_compress as sc

    p = ctx.plan["t3"]
    cfg = get_config("tinyllama-1.1b", smoke=ctx.plan["smoke_only"])
    if ctx.shared and not ctx.plan["smoke_only"]:
        cfg = dataclasses.replace(cfg,
                                  num_layers=ctx.plan["t3_gloo_layers"])
    seq = p["seq"] if not ctx.plan["smoke_only"] else 64
    ccfg = sc.SketchCompressConfig(rows=p["rows"],
                                   log2_cols=p["log2_cols"] if not
                                   ctx.plan["smoke_only"] else 12,
                                   top_k=p["top_k"] if not
                                   ctx.plan["smoke_only"] else 100,
                                   momentum=p["momentum"])
    dmesh, axes = ctx.dmesh, ("data",)
    model = model_mod.init_params(
        cfg, torch.Generator(device=ctx.dev).manual_seed(0), device=ctx.dev,
        mesh=dmesh, policy=sh.ShardingPolicy(fsdp=False, act_mode="dp_only"))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    cstate = sc.sketch_compress_init(params, ccfg)
    n = cstate.error.numel()
    chunks = -(-n // sketch.TENSOR_CHUNK)
    out = {"layers": cfg.num_layers, "coords": n, "chunks": chunks,
           "steps": [], "launches": {}}
    _reset_peak(ctx)
    for step in range(p["steps"]):
        batch = _local_batch(train_batch(cfg, p["batch"], seq, 3000 + step,
                                         ctx.dev), dmesh)
        model.zero_grad(set_to_none=True)
        total, _ = model_mod.forward_train(cfg, model, batch)
        total.backward()
        grads = {nm: q.grad for nm, q in params.items()}
        ctx.sync()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        upd, cstate, density = sc.compress_and_reduce(
            grads, cstate, ccfg, axis_names=axes, mesh=dmesh)
        ctx.sync()
        t1 = time.perf_counter()
        launches = {op: c for op, c in LAUNCHES.items() if c}
        out["launches"][step + 1] = launches
        if ctx.cuda and launches != {"sketch_update_table": chunks,
                                     "sketch_estimate_table": chunks}:
            raise AssertionError(f"[lm-mesh] M-T3 step {step + 1}: "
                                 f"launches {launches}, expected "
                                 f"{chunks} of K7 and of K8")
        with torch.no_grad():
            for nm, q in params.items():
                q.add_(upd[nm], alpha=-p["lr"])
        out["steps"].append(dict(loss=float(total.detach()),
                                 compress_ms=(t1 - t0) * 1e3,
                                 density=float(density)))
        del upd
    # one more round on the last step's gradients, taken apart (its
    # launches are not the path's)
    ctx.sync()
    t0 = time.perf_counter()
    own = sc.local_sketch(grads, cstate, ccfg)
    ctx.sync()
    t1 = time.perf_counter()
    merged = sketch.psum_merge(own, dmesh, axes)
    ctx.sync()
    t2 = time.perf_counter()
    upd, cstate, _ = sc.decompress(merged, grads, cstate, ccfg)
    ctx.sync()
    t3 = time.perf_counter()
    sketch.tensor_sketch_estimate(merged, n)
    ctx.sync()
    t4 = time.perf_counter()
    del upd, grads
    model.zero_grad(set_to_none=True)
    # the merged float table: the same bits on every rank, and within the
    # rounding of W - 1 float32 adds of the float64 sum of the ranks' own
    every = mesh_mod.all_gather_dim(own.table[None], dmesh, axes, 0).double()
    exact = every.sum(dim=0)
    bound = (ctx.world - 1) * 2.0 ** -24 * every.abs().sum(dim=0)
    err = (merged.table.double() - exact).abs()
    within = bool((err <= bound).all())
    ratio = float((err / bound.clamp(min=1e-300)).max())
    del every, exact, bound, err
    bits = merged.table.view(torch.int32).to(torch.int64)
    digest = torch.stack([bits.sum(), (bits * torch.arange(
        1, bits.shape[1] + 1, device=bits.device)).sum()]).to(torch.float64)
    digests = mesh_mod.all_gather_dim(digest[None], dmesh, axes, 0)
    same_bits = bool((digests == digests[0]).all())
    del bits, own, merged
    out["split"] = dict(sketch_ms=(t1 - t0) * 1e3, merge_ms=(t2 - t1) * 1e3,
                        decompress_ms=(t3 - t2) * 1e3,
                        estimate_ms=(t4 - t3) * 1e3, err_ratio=ratio,
                        within=within, same_bits=same_bits)
    if not (within and same_bits):
        raise AssertionError(f"[lm-mesh] M-T3: the merged table within "
                             f"(W - 1)·2^-24·sum|t| of the exact sum "
                             f"{within} (worst {ratio:.3e} of it), the same "
                             f"bits on every rank {same_bits}")
    # integer-valued gradients: the merged table is one device's sketch
    # of the summed gradient, bit for bit
    g = _int_grads(model, 500 + ctx.rank, ctx.dev)
    merged = sc.merged_sketch(g, cstate, ccfg, axes, dmesh).table
    del g
    same = True
    if ctx.rank == 0:
        total_g = None
        for r in range(ctx.world):
            g = _int_grads(model, 500 + r, ctx.dev)
            total_g = g if total_g is None else {
                k: total_g[k] + v for k, v in g.items()}
            del g
        one = sc.local_sketch(total_g, cstate, ccfg).table
        same = torch.equal(one, merged)
        del total_g, one
    same = bool(mesh_mod.all_reduce(torch.tensor(float(same),
                                                 device=ctx.dev),
                                    dmesh, axes, op="min"))
    out["int_equal"] = same
    if not same:
        raise AssertionError("[lm-mesh] M-T3: on integer gradients the "
                             "merged table is not one device's sketch "
                             "of the sum")
    out["peak_gib"], out["reserved_gib"] = _peak(ctx)
    del model, params, cstate
    ctx.free()
    return out


def lm_mesh_jamba(ctx):
    """(e) M-J: jamba-v0.1-52b at full width, 8 layers, bf16, AdamW, remat,
    B 4 x S 2048 on four cards: 3 timed steps after a warm-up."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.train import steps

    p = dict(ctx.plan["jamba"])
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b",
                                         smoke=ctx.plan["smoke_only"]),
                              num_layers=p["layers"])
    if ctx.plan["smoke_only"]:
        p["seq"] = 64
    tcfg = steps.TrainStepConfig(optimizer="adamw", remat=True)
    mesh = ctx.mesh
    batches = [_local_batch(train_batch(cfg, p["batch"], p["seq"], 5000 + i,
                                        ctx.dev), mesh)
               for i in range(p["steps"] + 1)]
    _reset_peak(ctx)
    state = _sharded_state(ctx, cfg, tcfg,
                           sh.ShardingPolicy(act_mode="embed_tp"))
    init_peak, _ = _peak(ctx)
    step_fn = steps.make_train_step(cfg, tcfg)
    state, ms, coll, big, losses = _timed_steps(ctx, step_fn, state, batches,
                                                ctx.backend == "nccl")
    peak, reserved = _peak(ctx)
    del state
    ctx.free()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("[lm-mesh] M-J: a loss is not finite")
    return dict(params=cfg.param_count(), batch=p["batch"], seq=p["seq"],
                losses=losses, ms=ms, coll_ms=coll, big=big, peak_gib=peak,
                reserved_gib=reserved, init_peak_gib=init_peak)


def lm_mesh_ckpt(ctx):
    """(f): a Trainer (tinyllama SMOKE, f32, AdamW) on the layout's mesh
    for 2 steps with a checkpoint after each; rank 0 restores the newest
    onto one device, equal to the gathered shards bit for bit; a Trainer
    resumed from step 1 on the same mesh ends with the same bits as the
    run that was not stopped."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig, state_tree

    cfg = dataclasses.replace(get_config("tinyllama-1.1b", smoke=True),
                              param_dtype="float32", compute_dtype="float32")
    tcfg = steps.TrainStepConfig(optimizer="adamw", peak_lr=1e-2,
                                 warmup_steps=1, total_steps=4)
    mesh = ctx.mesh
    root = ctx.tmp / "ckpt"

    def batch_fn(s):
        return train_batch(cfg, 4, 32, 6000 + s, ctx.dev)

    def run(d):
        rc = TrainerConfig(ckpt_dir=str(root / d), total_steps=2,
                           ckpt_every=1, log_every=1)
        tr = Trainer(cfg, tcfg, rc, batch_fn, device=ctx.dev, mesh=mesh,
                     policy=sh.ShardingPolicy(act_mode="seq_tp"))
        start = tr.start_step
        tr.run()
        return start, state_tree(tr.state, full=True)

    _, a = run("a")
    if ctx.rank == 0:
        shutil.copytree(root / "a", root / "b")
        shutil.rmtree(root / "b" / "step_00000002")
    ctx.barrier()
    start, b = run("b")
    resumed = start == 1 and all(torch.equal(t, b["params"][n])
                                 for n, t in a["params"].items()) and all(
        torch.equal(t, b["opt"].m[n]) for n, t in a["opt"].m.items())
    restored = True
    if ctx.rank == 0:
        like = steps.init_train_state(
            cfg, tcfg, torch.Generator(device=ctx.dev).manual_seed(1),
            device=ctx.dev, tp=tp_size(mesh))
        tree = restore_checkpoint(str(root / "a"), 2, state_tree(like))
        restored = all(torch.equal(t.cpu(), a["params"][n])
                       for n, t in tree["params"].items()) and all(
            torch.equal(t.cpu(), a["opt"].v[n])
            for n, t in tree["opt"].v.items())
    if not (resumed and restored):
        raise AssertionError(f"[lm-mesh] (f): resume bit-exact {resumed}, "
                             f"restore onto one device bit-equal "
                             f"{restored}")
    return dict(resumed=resumed, restored=restored)


def lm_mesh_serve_twin(ctx, cfg, batch, prompt, steps, on_card, pol):
    """(g1)/(g2): ``cfg``'s prefill of ``prompt`` tokens and ``steps``
    greedy decode steps on one device, then the same weights cut to this
    rank's blocks under ``pol`` (in place) through the sharded prefill
    and decode steps fed the same tokens: every step's logits (the rank's
    rows) within LM_TWIN_TOL·max|logits| of one device's.  Returns the
    worst ratio."""
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import tp_size
    from repro_torch.train import steps as st

    mesh, tp = ctx.mesh, tp_size(ctx.mesh)
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    cache = prefix + prompt + steps + 1
    inputs = serve_mod.make_batch(cfg, batch, prompt,
                                  torch.Generator().manual_seed(7), ctx.dev)
    decode = st.make_decode_step(cfg)
    together = not on_card or ctx.world * 2 * 4 * cfg.param_count() \
        <= LM_MESH_TWINS_TOGETHER_BYTES
    for mine in (True,) if together else ctx.turns():
        if not mine:
            continue
        model = _draw(cfg, tp, ctx.dev, on_card)
        digest = _digest(model)
        logits, state = st.make_prefill_step(cfg, cache, tp=tp)(model,
                                                                inputs)
        one, fed = [logits.cpu()], []
        for _ in range(steps):
            fed.append(torch.argmax(logits, -1))
            logits, state = decode(model, fed[-1][:, None], state)
            one.append(logits.cpu())
        del state, logits
        sh.shard_model(model, mesh, pol)
        ctx.free()
    _same_draw_everywhere(ctx, digest)
    logits, state = st.make_prefill_step(cfg, cache, mesh=mesh,
                                         policy=pol)(model, inputs)
    lay = state["layout"]
    got = [logits.cpu()]
    for tok in fed:
        logits, state = decode(model, lay.rows(tok)[:, None], state)
        got.append(logits.cpu())
    worst = 0.0
    for a, b in zip(one, got):
        want = lay.rows(a)
        worst = max(worst, float((b - want).abs().max())
                    / max(float(a.abs().max()), 1e-30))
    del model, state
    ctx.free()
    if worst > LM_TWIN_TOL:
        raise AssertionError(f"[lm-mesh] (g) {cfg.arch_id} B {batch}: "
                             f"logits {worst:.3e}·max|logits| off one "
                             f"device's")
    return {"err": worst, "seq_axes": list(lay.seq_axes),
            "batch_axes": list(lay.batch_axes), "slots": lay.slots}


def _cache_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for g in ("layers", "cross")
               for c in state.get(g, ()) for t in c.values())


def _launches(ctx, fn):
    """Kernel launches (CUDA records of torch.profiler) of one call of
    ``fn`` on this rank's card; None off the card."""
    if not ctx.cuda:
        fn()
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(c for _, c, _ in device_kernels(prof)[1])


def lm_mesh_serve_cell(ctx, name, p):
    """(g3)-(g5): ``p``'s cell on the mesh in bf16, the weights cut at the
    draw: ``serve`` once, then the same prefill and greedy decode steps by
    hand, each step timed with its collectives (equal tokens both times,
    finite logits); one more decode step, profiled and under
    ``count_collectives``.  Returns the numbers (g) prints and the
    counted calls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as model_mod
    from repro_torch.train import steps as st

    smoke = ctx.plan["smoke_only"]
    cfg = get_config(p["arch"], smoke=smoke)
    layers, gen, prompt = p["layers"], p["gen"], p["prompt"]
    cut = ""
    if ctx.shared and not smoke:
        layers, gen = ctx.plan["serve_gloo"]["layers"], \
            ctx.plan["serve_gloo"]["gen"]
        cut = (f" (ranks sharing one card: {layers} layers, gen {gen}; "
               f"every collective is staged through the host)")
    if smoke:
        prompt, gen = min(prompt, 64), min(gen, 4)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    b, mesh, pol = p["batch"], ctx.mesh, sh.ShardingPolicy()
    _reset_peak(ctx)
    t0 = time.perf_counter()
    model = model_mod.init_params(
        cfg, torch.Generator(device=ctx.dev).manual_seed(0), device=ctx.dev,
        mesh=mesh, policy=pol)
    ctx.sync()
    draw_s = time.perf_counter() - t0
    first = serve_mod.serve(cfg, b, prompt, gen, seed=0, device=ctx.dev,
                            model=model, mesh=mesh, policy=pol)
    cache = prompt + gen
    prompt_batch = serve_mod.make_batch(cfg, b, prompt,
                                        torch.Generator().manual_seed(1),
                                        ctx.dev)
    nccl = ctx.backend == "nccl"
    with CollectiveClock(nccl, sync_card=ctx.cuda) as clock:
        ctx.sync()
        t1 = time.perf_counter()
        logits, state = st.make_prefill_step(cfg, cache, mesh=mesh,
                                             policy=pol)(model, prompt_batch)
        ctx.sync()
        prefill_host_ms = (time.perf_counter() - t1) * 1e3
        prefill_coll = clock.ms()
    lay = state["layout"]
    decode = st.make_decode_step(cfg)
    toks, finite = [torch.argmax(logits, -1)], bool(torch.isfinite(
        logits).all())
    ms, coll = [], []
    for _ in range(gen - 1):
        with CollectiveClock(nccl, sync_card=ctx.cuda) as clock:
            ctx.sync()
            if ctx.cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            t1 = time.perf_counter()
            logits, state = decode(model, toks[-1][:, None], state)
            toks.append(torch.argmax(logits, -1))
            if ctx.cuda:
                e1.record()
            ctx.sync()
            ms.append(e0.elapsed_time(e1) if ctx.cuda
                      else (time.perf_counter() - t1) * 1e3)
            coll.append(clock.ms())
        finite = finite and bool(torch.isfinite(logits).all())
    tokens = torch.stack(toks, 1)
    if lay.batch_axes:
        tokens = mesh_mod.all_gather_dim(tokens, mesh, lay.batch_axes, 0)
    same = torch.equal(tokens, first.tokens)
    finite = finite and all(bool(torch.isfinite(lg).all())
                            for lg in first.logits)
    with mesh_mod.count_collectives() as counter:
        launches = _launches(ctx, lambda: decode(
            model, toks[-1][:, None], state))
    peak, reserved = _peak(ctx)
    one_device = _cache_bytes(model_mod.init_decode_state(
        cfg, b, cache, device="meta"))
    out = dict(arch=p["arch"], layers=cfg.num_layers, batch=b,
               prompt=prompt, gen=gen, cut=cut, cache_len=cache,
               draw_s=draw_s, prefill_ms=first.prefill_ms,
               prefill_host_ms=prefill_host_ms, prefill_coll_ms=prefill_coll,
               decode_ms=first.decode_ms, ms=ms, coll_ms=coll,
               launches=launches, calls=counter.calls, peak_gib=peak,
               reserved_gib=reserved, cache_bytes=_cache_bytes(state),
               one_device_cache_bytes=one_device, same=same, finite=finite,
               seq_axes=list(lay.seq_axes), batch_axes=list(lay.batch_axes))
    del model, state, first, logits
    ctx.free()
    if not (same and finite):
        raise AssertionError(f"[lm-mesh] (g) {name}: tokens equal twice "
                             f"{same}, logits finite {finite}")
    return out


def lm_mesh_serve(ctx):
    """(g): serving on the mesh: (g1) the SMOKE twins at B 4 and B 1, (g2)
    the full-width twins, (g3) M-L1, (g4) M-LL, (g5) M-L2 on 4 cards."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import sharding as sh
    out = {"g1": {}, "g2": [], "cells": {}}
    sm = ctx.plan["serve_smoke"]
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        for b in sm["batches"]:
            out["g1"][f"{arch} B {b}"] = lm_mesh_serve_twin(
                ctx, cfg, b, sm["prompt"], sm["steps"], False,
                sh.ShardingPolicy())
    if not ctx.plan["smoke_only"]:
        for arch, layers, b, prompt, steps in ctx.plan["serve_wide"]:
            cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                      param_dtype="float32",
                                      compute_dtype="float32")
            t0 = time.perf_counter()
            w = lm_mesh_serve_twin(ctx, cfg, b, prompt, steps, True,
                                   sh.ShardingPolicy(fsdp=not ctx.shared))
            w.update(arch=arch, layers=layers, batch=b, prompt=prompt,
                     steps=steps, fsdp=not ctx.shared,
                     secs=time.perf_counter() - t0)
            out["g2"].append(w)
    for name, p in ctx.plan["serve"].items():
        if p.get("cards", 1) > 1 and (ctx.world != p["cards"] or ctx.shared):
            continue
        out["cells"][name] = lm_mesh_serve_cell(ctx, name, p)
    return out


def lm_mesh_serve_dryrun(name, world, reps, plan):
    """Beside (g3)-(g5): each cell's dry run (``launch/dryrun.py``) of one
    decode step on this layout's mesh for every rank, in this process
    (a fake group of the mesh's size): rank 0's record and roofline
    printed, and each rank's counted calls of its real decode step held
    to its dry run's, call for call."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    shape = (2, world // 2) if world % 2 == 0 else (1, world)
    names = ("data", "model")
    for cell, c in reps[0]["g"]["cells"].items():
        cfg = dataclasses.replace(get_config(c["arch"],
                                             smoke=plan["smoke_only"]),
                                  num_layers=c["layers"])
        for r in reps:
            rec = dryrun.record(cfg, "decode", c["batch"], c["cache_len"],
                                shape, names, rank=r["rank"])
            got = r["g"]["cells"][cell]["calls"]
            want = rec["calls"]
            if got != want:
                raise AssertionError(
                    f"[lm-mesh] (g) {name} {cell} rank {r['rank']}: the "
                    f"counted collectives of a decode step {got[:4]}... "
                    f"({len(got)} calls) differ from the dry run's "
                    f"{want[:4]}... ({len(want)})")
            if r["rank"] == 0:
                rec.update(arch=c["arch"], shape=cell, mesh=str(shape),
                           overrides={"num_layers": c["layers"]})
                terms = roofline.roofline_terms(rec)
                bound = max(terms["compute_s"], terms["memory_s"],
                            terms["collective_s"]) * 1e3
                coll = rec["collectives"]
                log(f"[lm-mesh] {name} (g) {cell} dry run of a decode step "
                    f"(rank 0 of {shape}, meta device, fake group): dot "
                    f"FLOPs {rec['counts']['flops']:.6g} a rank; "
                    f"collectives {coll['total']} B in {coll['num_ops']} "
                    f"calls by kind {coll['per_kind']} (across hosts "
                    f"{coll['dcn']} B); roofline at the H100 defaults: "
                    f"compute {terms['compute_s'] * 1e3:.4f} ms, memory "
                    f"{terms['memory_s'] * 1e3:.4f} ms, collective "
                    f"{terms['collective_s'] * 1e3:.4f} ms, bound "
                    f"{bound:.4f} ms ({terms['bottleneck']}); memory a rank "
                    f"{terms['mem_per_dev_gb']} GB without temporaries; "
                    f"every rank's counted calls == its dry run's: "
                    f"{len(want)} calls, {sum(x[2] for x in want)} B")


def phase_lm_mesh(device, layouts=None, plan=None):
    """Phase lm-mesh: the LM stack's training on a mesh (see the module
    docstring), each layout's ranks spawned (the kernels built by this
    process), then the gates' prints and (d)'s launches under
    ``LM:<layout>:T3:<step>:r<rank>``."""
    import shutil
    import tempfile
    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    plan = plan or lm_mesh_plan()
    smi = nvidia_smi_line() if plan["device_type"] == "cuda" else "cpu"
    if layouts is None:
        layouts = mesh_layouts(torch.cuda.device_count())
    gc.collect()
    if plan["device_type"] == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    root = Path(tempfile.mkdtemp(prefix="lm-mesh-"))
    k7, k8 = "sketch_update_table", "sketch_estimate_table"
    try:
        for name, world, backend, shared in layouts:
            tmp = root / name
            tmp.mkdir()
            t0 = time.perf_counter()
            reps = run_ranks(ctx, world, backend, shared, tmp, (plan,),
                             target=lm_mesh_rank, timeout=LM_MESH_TIMEOUT_S)
            wall = time.perf_counter() - t0
            lm_mesh_report(name, world, reps, wall, smi)
            lm_mesh_serve_dryrun(name, world, reps, plan)
            for r in reps:
                for s, ls in r["d"]["launches"].items():
                    PATH_LAUNCHES[f"LM:{name}:T3:{s}:r{r['rank']}"] = ls
                    if plan["device_type"] == "cuda" and ls != {
                            k7: r["d"]["chunks"], k8: r["d"]["chunks"]}:
                        raise AssertionError(f"[lm-mesh] {name} rank "
                                             f"{r['rank']} T3 step {s}: "
                                             f"launches {ls}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[lm-mesh] phase {time.perf_counter() - t_phase:.1f} s")


def _fmt(v, nd=2):
    return "n/a" if v is None else f"{v:.{nd}f}"


def lm_mesh_report(name, world, reps, wall, smi):
    """Prints one layout's lm-mesh numbers (the gates ran on the ranks)."""
    r0 = reps[0]
    log(f"[lm-mesh] {name}: {world} rank(s), {wall:.1f} s; {smi}; seconds "
        f"a step of the phase (rank 0): "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["secs"].items()))
    for key, w in r0["a"].items():
        worst = max((r["a"][key] for r in reps), key=lambda x: x["grad"])
        log(f"[lm-mesh] {name} (a) {key}: |d loss|/loss "
            f"{max(r['a'][key]['loss'] for r in reps):.3e}, max |d g|/"
            f"max|g| {worst['grad']:.3e} ({worst['grad_leaf']}), step "
            f"{_fmt(max(r['a'][key].get('step', 0) for r in reps), 4)}·lr "
            f"where |g| is sure"
            + ("" if w.get("dropped") is None
               else f", dropped share {w['dropped']!r} on both"))
    for i, w in enumerate(r0.get("b", ())):
        g = max(r["b"][i]["grad"] for r in reps)
        lo = max(r["b"][i]["loss"] for r in reps)
        log(f"[lm-mesh] {name} (b) {w['arch']} full width, {w['layers']} "
            f"layer(s), f32, B {w['batch']} x S {w['seq']}: |d loss|/loss "
            f"{lo:.3e}, max |d g|/max|g| {g:.3e} ({w['grad_leaf']}), "
            f"{w['secs']:.1f} s (one device's twin and the cut "
            f"{w['single_s']:.1f} s)")
    for r in reps:
        c = r["c"]
        p50 = statistics.median(c["ms"])
        tokens = c["batch"] * c["seq"]
        log(f"[lm-mesh] {name} (c) M-T1 rank {r['rank']}: llama3.2-3b "
            f"{c['layers']} layers bf16 AdamW remat, B {c['batch']} x S "
            f"{c['seq']}: first-step loss {c['first']!r} twice; step ms "
            f"{[round(v, 2) for v in c['ms']]} (warm-up "
            f"{c['warm_ms']:.2f}), p50 {p50:.2f} ms, {tokens / p50 * 1e3:.0f}"
            f" tokens/s; collectives ms a step "
            f"{[round(v, 2) for v in c['coll_ms']]} (calls of 64 MiB or "
            f"more: {[(k, round(v, 2)) for k, v in c['big']]}); losses "
            f"{[round(v, 5) for v in c['losses']]}; peak "
            f"{_fmt(c['peak_gib'])} GiB, reserved {_fmt(c['reserved_gib'])}"
            f" GiB; {c['local_params']} parameters on the rank")
    for r in reps:
        d = r["d"]
        for i, s in enumerate(d["steps"]):
            log(f"[lm-mesh] {name} (d) M-T3 rank {r['rank']} step {i + 1}: "
                f"tinyllama-1.1b {d['layers']} layers, {d['coords']} "
                f"coordinates in {d['chunks']} chunks: loss "
                f"{s['loss']:.5f}; compress_and_reduce {s['compress_ms']:.2f}"
                f" ms; density {s['density']:.4e}; launches "
                f"{d['launches'][i + 1]}")
        sp = d["split"]
        log(f"[lm-mesh] {name} (d) rank {r['rank']}: one more round apart: "
            f"sketch {sp['sketch_ms']:.2f} ms, merge (all-reduce) "
            f"{sp['merge_ms']:.2f} ms, decompress {sp['decompress_ms']:.2f}"
            f" ms (the estimate alone {sp['estimate_ms']:.2f} ms); merged "
            f"float table within the bound {sp['within']} (worst "
            f"{sp['err_ratio']:.3e} of it), the same bits on every rank "
            f"{sp['same_bits']}")
        log(f"[lm-mesh] {name} (d) rank {r['rank']}: integer gradients' "
            f"merged table == one device's sketch of the sum "
            f"{d['int_equal']}; peak {_fmt(d['peak_gib'])} GiB, reserved "
            f"{_fmt(d['reserved_gib'])} GiB")
    for r in reps:
        if "e" in r:
            e = r["e"]
            p50 = statistics.median(e["ms"][1:])
            log(f"[lm-mesh] {name} (e) M-J rank {r['rank']}: jamba-v0.1-52b "
                f"8 layers ({e['params']} params) bf16 AdamW, B "
                f"{e['batch']} x S {e['seq']}: step ms "
                f"{[round(v, 2) for v in e['ms']]}, p50 after the warm-up "
                f"{p50:.2f} ms, {e['batch'] * e['seq'] / p50 * 1e3:.0f} "
                f"tokens/s, collectives ms {[round(v, 2) for v in e['coll_ms']]}"
                f" (calls of 64 MiB or more: "
                f"{[(k, round(v, 2)) for k, v in e['big']]}); losses "
                f"{[round(v, 5) for v in e['losses']]}; peak "
                f"{_fmt(e['peak_gib'])} GiB (after the draw "
                f"{_fmt(e['init_peak_gib'])}), reserved "
                f"{_fmt(e['reserved_gib'])} GiB")
    log(f"[lm-mesh] {name} (f) checkpoints: restored onto one device "
        f"bit-equal {r0['f']['restored']}, resumed on the mesh bit-exact "
        f"{all(r['f']['resumed'] for r in reps)}")
    g = r0["g"]
    for key, w in g["g1"].items():
        worst = max(r["g"]["g1"][key]["err"] for r in reps)
        log(f"[lm-mesh] {name} (g1) {key} f32: prefill + 6 teacher-forced "
            f"decode steps, max |d logits| {worst:.3e}·max|logits| of one "
            f"device's (bar {LM_TWIN_TOL}); sequence over {w['seq_axes']}, "
            f"batch over {w['batch_axes']}, {w['slots']} slots a rank")
    for i, w in enumerate(g["g2"]):
        worst = max(r["g"]["g2"][i]["err"] for r in reps)
        log(f"[lm-mesh] {name} (g2) {w['arch']} full width, {w['layers']} "
            f"layer(s), f32, B {w['batch']} x prompt {w['prompt']}, "
            f"{w['steps']} decode steps, FSDP {w['fsdp']}: max |d logits| "
            f"{worst:.3e}·max|logits| (bar {LM_TWIN_TOL}), {w['secs']:.1f} s")
    for r in reps:
        for cell, c in r["g"]["cells"].items():
            steps = c["ms"]
            p50 = statistics.median(steps)
            p99 = max(steps) if len(steps) < 100 else \
                statistics.quantiles(steps, n=100)[98]
            coll = statistics.median(c["coll_ms"])
            log(f"[lm-mesh] {name} (g) {cell} rank {r['rank']}: {c['arch']} "
                f"{c['layers']} layers bf16, B {c['batch']} x prompt "
                f"{c['prompt']}, gen {c['gen']}{c['cut']}: weights cut at "
                f"the draw in {c['draw_s']:.1f} s; serve: prefill "
                f"{c['prefill_ms']:.2f} ms, decode p50 "
                f"{statistics.median(c['decode_ms']):.3f} ms; by hand: "
                f"prefill {c['prefill_host_ms']:.2f} ms (collectives "
                f"{c['prefill_coll_ms']:.2f}), decode step ms "
                f"{[round(v, 3) for v in steps]}, p50 {p50:.3f}, p99 (the "
                f"max below 100 steps) {p99:.3f}, "
                f"{c['batch'] * len(steps) / sum(steps) * 1e3:.0f} tok/s; "
                f"collectives {coll:.3f} ms a step (p50, "
                f"{coll / p50:.1%}); {c['launches']} launches a step; "
                f"{len(c['calls'])} collective calls, "
                f"{sum(x[2] for x in c['calls'])} B a step; peak "
                f"{_fmt(c['peak_gib'])} GiB (reserved "
                f"{_fmt(c['reserved_gib'])}); caches "
                f"{c['cache_bytes'] / 2**20:.2f} MiB a rank, one device's "
                f"{c['one_device_cache_bytes'] / 2**20:.2f} MiB (sequence "
                f"over {c['seq_axes']}, batch over {c['batch_axes']}); "
                f"tokens equal twice {c['same']}")


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
    ap.add_argument("--only", choices=("lm-mesh",), default=None,
                    help="build the kernels and run this phase alone "
                         "(prints no result line)")
    ap.add_argument("--layouts", default=None,
                    help="with --only lm-mesh: a comma list of its layouts "
                         "(gloo4, nccl1, nccl4; default every one the "
                         "visible cards allow)")
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
    if args.only == "lm-mesh":
        layouts = None
        if args.layouts:
            every = {lay[0]: lay for lay in mesh_layouts(
                torch.cuda.device_count())}
            layouts = [every[name] for name in args.layouts.split(",")]
        phase_lm_mesh(device, layouts=layouts)
        log(f"[done] lm-mesh alone {time.perf_counter() - t_start:.1f} s; "
            f"{nvidia_smi_line()}")
        return 0
    phase_check(device)
    pts, pts_np, warm, spec = make_points(device, args.points)
    cfg, res = phase_main(device, pts, warm, spec)
    k1 = phase_kernels(cfg, res)
    del res
    k2, k3, k1_sparse = phase_tsne_sparse(device, pts, warm, spec)
    k1["per_call"]["tsne_sparse"] = k1_sparse
    k5a, k5b = phase_tsne_exact(device, pts, warm, spec)
    k4, k2_ann, k3_ann, ref_a = phase_ann(device, pts, warm, spec)
    k2["per_call"] = {"tsne_sparse": dict(k2), "ann": k2_ann}
    k3["per_call"] = {"tsne_sparse": dict(k3), "ann": k3_ann}
    cfg_i, state, runs, peak = phase_stream(device, pts, pts_np, warm, spec)
    phase_ops(device, pts, cfg_i)
    k6, k7, k8 = phase_sketch_kernels(device, pts, cfg_i, state, runs)
    del state, runs
    phase_service(device, pts, pts_np, spec)
    phase_mesh(device, pts, pts_np, spec, ref_a)
    del pts, pts_np
    phase_parity(cfg, device, peak, args.points)
    phase_lm(device)
    train_rows = phase_train(device)
    phase_lm_mesh(device)
    for k in (k7, k8):
        k["per_call"] = dict(k.get("per_call") or {},
                             train=train_rows[k["name"]])
    log(f"[done] whole run {time.perf_counter() - t_start:.1f} s")
    kernels = [k1, k2, k3, k4, k5a, k5b, k6, k7, k8]
    for k in kernels:
        k["launches_by_path"] = launches_by_path(k["name"])
        k["launches"] = sum(k["launches_by_path"].values())
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
