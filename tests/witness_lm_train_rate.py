#!/usr/bin/env python3
"""Does the reference's loss rise like the port's in the first steps of a
bf16 AdamW run at peak rate 3e-4 with one warm-up step?  A CPU witness.

    PYTHONPATH=src python tests/witness_lm_train_rate.py [--layers 2]

llama3.2-3b at its full widths (d 3 072, GQA 24/8, MLP 8 192, vocab
128 256, untied head) cut to ``--layers`` layers, bf16, AdamW, remat
"nothing", B 1 x S 64 zipf tokens (the reference's tokens, the port's bit
for bit), six steps under each schedule:

* ``warm1``: peak 3e-4, one warm-up step, six steps in all;
* ``default``: the stack's ``TrainStepConfig`` schedule (peak 3e-4, 100
  warm-up steps, 10 000 in all), whose first six steps chip_smoke's T1
  runs.

Each (side, schedule) runs in a process of its own, which imports only
its package: ``ref`` the JAX reference (``jax.jit`` with a donated state,
as its ``Trainer`` runs the step), ``port`` the PyTorch port on the CPU.
Each draws its own weights from seed 0, so the two sides' losses agree
in their course, not their bits.  Prints one line a run with the six
losses; about 16 GB of host memory a process at two layers, a few
minutes in all.  Not collected by pytest.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

BATCH, SEQ, STEPS = 1, 64, 6
SCHEDULES = {"warm1": dict(peak_lr=3e-4, warmup_steps=1, total_steps=STEPS),
             "default": {}}


def run_ref(layers: int, schedule: str) -> list:
    import jax
    from repro.configs import get_config
    from repro.data.synthetic import zipf_token_stream
    from repro.train.steps import (TrainStepConfig, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=layers)
    tcfg = TrainStepConfig(optimizer="adamw", q_chunk=SEQ,
                           remat_policy="nothing", **SCHEDULES[schedule])
    state = init_train_state(jax.random.key(0), cfg, tcfg)
    step = jax.jit(make_train_step(cfg, tcfg), donate_argnums=0)
    losses = []
    for i in range(STEPS):
        batch = zipf_token_stream(jax.random.key(1000 + i), BATCH, SEQ,
                                  cfg.vocab_size)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def run_port(layers: int, schedule: str) -> list:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.synthetic import zipf_token_stream
    from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                         make_train_step)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=layers)
    tcfg = TrainStepConfig(optimizer="adamw", q_chunk=SEQ,
                           remat_policy="nothing", **SCHEDULES[schedule])
    state = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, tcfg)
    losses = []
    for i in range(STEPS):
        batch = zipf_token_stream(prng.key(1000 + i, "cpu"), BATCH, SEQ,
                                  cfg.vocab_size)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--side", choices=("ref", "port"))
    ap.add_argument("--schedule", choices=tuple(SCHEDULES))
    args = ap.parse_args()
    if args.side:
        t0 = time.perf_counter()
        fn = run_ref if args.side == "ref" else run_port
        losses = fn(args.layers, args.schedule)
        print(json.dumps({"side": args.side, "schedule": args.schedule,
                          "layers": args.layers, "losses": losses,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for schedule in SCHEDULES:
        for side in ("ref", "port"):
            subprocess.run([sys.executable, __file__, "--layers",
                            str(args.layers), "--side", side, "--schedule",
                            schedule], env=env, check=True)


if __name__ == "__main__":
    main()
