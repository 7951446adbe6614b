#!/usr/bin/env python3
"""Where the LM serving path's bf16 teacher-forced gap comes from, on the
card.

    python3 chip_diag_lm.py

chip_smoke.py's phase ``lm`` checks, for L1 (llama3.2-3b, all 28 layers)
and L2 (jamba-v0.1-52b at full width, one superblock of 8 layers), that a
prefill over L − 1 tokens and one decode step give the logits of a
prefill over L (L 512 and 256, B 8, the prompt chip_smoke draws).  This
script takes each model with weights drawn on the CPU from seed 0 (so the
CPU and the card hold the same weights) and prints:

* ``card bf16 rpr=True|False``: the teacher-forced gap in bf16 with
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  at torch's default (True: cuBLAS's split-K bf16 GEMMs may add their
  partial sums in bf16) and off (partial sums in f32, as the reference's
  bf16 dots accumulate); each bf16 result's error against the f32
  prefill over L on the same weights upcast (the "truth"); ms a decode
  step at position L (CUDA events, 10 steps);
* ``card f32``: the same gap with the weights upcast;
* ``cpu bf16``: the port on the host's CPU (oneDNN bf16 GEMMs accumulate
  in f32) on the same weights and the first CPU_BATCH rows: its
  teacher-forced gap, its errors against the card's f32 truth, and the
  card's bf16 prefill against the CPU's.  At B 1 L2's static-capacity
  MoE has 40 slots an expert, not B 8's 320, so its CPU rows may drop an
  assignment that the card's batch keeps.

A gap is max and mean |d logits| and the share of logits outside the
reference's bar, rtol = atol = 2e-2.  Prints the nvidia-smi
name/power-limit line.  About 10 minutes on one H100 and its host, most
of it drawing the weights on the CPU.
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 8
CPU_BATCH = 1
DECODE_STEPS = 10


def log(*args):
    print(*args, flush=True)


def stats(a, ref) -> str:
    d = (a - ref).abs()
    out = (d > 2e-2 + 2e-2 * ref.abs()).float().mean()
    return (f"max {float(d.max()):.3e}, mean {float(d.mean()):.3e}, "
            f"outside 2e-2 {float(out):.2%}")


def teacher_forced(cfg, model, tokens):
    """(prefill over L, prefill over L − 1 then one decode step): the f32
    logits of the last position, on the CPU."""
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    prefill = make_prefill_step(cfg, tokens.shape[1])
    full, _ = prefill(model, {"tokens": tokens})
    _, st = prefill(model, {"tokens": tokens[:, :-1]})
    step, _ = make_decode_step(cfg)(model, tokens[:, -1:], st)
    return full.cpu(), step.cpu()


def decode_ms(cfg, model, tokens) -> float:
    """Median ms of a decode step at position L after a prefill over L."""
    import statistics
    import torch
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    logits, state = make_prefill_step(cfg, tokens.shape[1] + 1)(
        model, {"tokens": tokens})
    tok = torch.argmax(logits, -1)[:, None]
    decode = make_decode_step(cfg)
    times = []
    for _ in range(DECODE_STEPS):
        state["pos"] = tokens.shape[1]
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        decode(model, tok, state)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run(tag, cfg, length, card):
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod

    t0 = time.perf_counter()
    host = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    model = model_mod.LM(cfg, device=card)
    model.load_state_dict(host.state_dict())
    tokens = serve.make_batch(cfg, BATCH, length,
                              torch.Generator().manual_seed(3),
                              "cpu")["tokens"]
    log(f"[{tag}] {cfg.arch_id}, {cfg.num_layers} layers, d {cfg.d_model}, "
        f"B {BATCH}, L {length}: weights drawn on the CPU and copied in "
        f"{time.perf_counter() - t0:.1f} s")
    rpr = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    bf16 = {}
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
        bf16[flag] = teacher_forced(cfg, model, tokens.to(card))
        ms = decode_ms(cfg, model, tokens.to(card))
        log(f"[{tag}] card bf16 rpr={flag}: teacher-forced gap "
            f"{stats(bf16[flag][1], bf16[flag][0])}; decode step {ms:.3f} ms")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = rpr
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model = model.float()
    full32, step32 = teacher_forced(cfg32, model, tokens.to(card))
    log(f"[{tag}] card f32: teacher-forced gap {stats(step32, full32)}; "
        f"|logits| <= {float(full32.abs().max()):.3f}")
    for flag, (full, step) in bf16.items():
        log(f"[{tag}] card bf16 rpr={flag} against the f32 prefill: prefill "
            f"{stats(full, full32)}; decode step {stats(step, full32)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    b = CPU_BATCH
    t0 = time.perf_counter()
    full_c, step_c = teacher_forced(cfg, host, tokens[:b])
    log(f"[{tag}] cpu bf16 ({torch.get_num_threads()} threads, B {b}, "
        f"{time.perf_counter() - t0:.1f} s): teacher-forced gap "
        f"{stats(step_c, full_c)} (the card's on these rows, rpr=True: "
        f"{stats(bf16[True][1][:b], bf16[True][0][:b])}; rpr=False: "
        f"{stats(bf16[False][1][:b], bf16[False][0][:b])})")
    log(f"[{tag}] cpu bf16 against the card's f32 prefill: prefill "
        f"{stats(full_c, full32[:b])}; decode step "
        f"{stats(step_c, full32[:b])}")
    for flag, (full, _) in bf16.items():
        log(f"[{tag}] card bf16 rpr={flag} prefill against the cpu's: "
            f"{stats(full[:b], full_c)}")
    del host
    gc.collect()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_diag_lm: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    run("L1", get_config("llama3.2-3b"), 512, card)
    jamba = get_config("jamba-v0.1-52b")
    run("L2", dataclasses.replace(jamba,
                                  num_layers=jamba.superblock_period()),
        256, card)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
