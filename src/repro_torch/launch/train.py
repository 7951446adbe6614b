"""Training launcher of the LM stack (the port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

Runs on the card unless ``--device`` names another device.  Batches are
``zipf_token_stream(prng.key(step), ...)``, the reference's tokens bit
for bit.  Checkpoints go to ``--ckpt-dir``, and a rerun with the same
directory resumes from its newest complete step; without the flag each
run writes to a fresh directory under ``tempfile.gettempdir()``.
``--monitor`` adds the SnS activation monitor.  Training over a mesh is
not here.
"""
from __future__ import annotations

import argparse
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from if it holds "
                         "one (default: a fresh one under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--monitor", action="store_true",
                    help="SnS activation monitor")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.device import resolve_device
    from repro_torch.data.synthetic import zipf_token_stream
    from repro_torch.train.steps import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainStepConfig(optimizer=args.optimizer, peak_lr=args.lr,
                           warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps,
                           q_chunk=min(1024, args.seq))
    rc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=ckpt_dir, log_every=10,
                       monitor_activations=args.monitor)

    def batch_fn(step):
        return zipf_token_stream(prng.key(step, dev), args.batch, args.seq,
                                 cfg.vocab_size)

    tr = Trainer(cfg, tcfg, rc, batch_fn, device=dev)
    if tr.start_step:
        print(f"[resume] from step {tr.start_step}")
    out = tr.run()
    for m in out["metrics"]:
        print(f"  step {int(m['step']):5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
    print(f"[done] {out['final_step']} steps in {out['wall_s']:.1f}s on "
          f"{dev}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
