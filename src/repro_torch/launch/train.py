"""Training launcher of the LM stack (the port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu] \
        [--mesh 2,2 [--act-mode seq_tp] [--host-devices 4]]

Runs on the card unless ``--device`` names another device.  Batches are
``zipf_token_stream(prng.key(step), ...)``, the reference's tokens bit
for bit.  Checkpoints go to ``--ckpt-dir``, and a rerun with the same
directory resumes from its newest complete step (on any mesh); without
the flag each run writes to a fresh directory under
``tempfile.gettempdir()``.  ``--monitor`` adds the SnS activation
monitor.

``--mesh`` trains on a mesh of that comma shape, its dimensions named
``("pod", "data", "model")[-len:]`` as in the reference, one process a
rank (this launcher starts them).  With ``--host-devices N`` the ranks
are N CPU processes on gloo (the reference's fake host devices; N must
be the mesh's size, and ``--device cpu``); otherwise each rank owns one
card on nccl, and a mesh larger than the visible cards raises.
"""
from __future__ import annotations

import argparse
import tempfile


def _rank_main(rank: int, dev, mesh, args) -> None:
    """One rank of a ``--mesh`` run (``launch.mesh.spawn_ranks``)."""
    from repro_torch.launch import sharding as sh
    if rank == 0:
        names = mesh.mesh_dim_names
        print(f"[mesh] {dict(zip(names, mesh.shape))} act_mode="
              f"{args.act_mode} on {'gloo' if dev.type == 'cpu' else 'nccl'}")
    _train(args, dev, mesh, sh.ShardingPolicy(act_mode=args.act_mode),
           verbose=rank == 0)


def _train(args, dev, mesh=None, policy=None, verbose=True) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.synthetic import zipf_token_stream
    from repro_torch.train.steps import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainStepConfig(optimizer=args.optimizer, peak_lr=args.lr,
                           warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps,
                           q_chunk=min(1024, args.seq))
    rc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, log_every=10,
                       monitor_activations=args.monitor)

    def batch_fn(step):
        return zipf_token_stream(prng.key(step, dev), args.batch, args.seq,
                                 cfg.vocab_size)

    tr = Trainer(cfg, tcfg, rc, batch_fn, device=dev, mesh=mesh,
                 policy=policy)
    if tr.start_step and verbose:
        print(f"[resume] from step {tr.start_step}")
    out = tr.run()
    if not verbose:
        return
    for m in out["metrics"]:
        print(f"  step {int(m['step']):5d} loss {m['loss']:.4f} "
              f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
    print(f"[done] {out['final_step']} steps in {out['wall_s']:.1f}s on "
          f"{dev}; checkpoints in {args.ckpt_dir}")


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
    ap.add_argument("--mesh", default="",
                    help="comma shape, e.g. 2,2,2 -> (pod,data,model); "
                         "empty = single device")
    ap.add_argument("--act-mode", default="seq_tp",
                    choices=("embed_tp", "seq_tp", "dp_only"))
    ap.add_argument("--host-devices", type=int, default=0,
                    help="CPU ranks on gloo for the mesh (with --device "
                         "cpu); default: one card a rank")
    args = ap.parse_args(argv)

    from repro_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    args.ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_train_")
    if not args.mesh:
        if args.host_devices:
            raise ValueError("--host-devices needs --mesh")
        _train(args, dev)
        return
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(_rank_main, args.mesh, args.host_devices, dev, (args,))


if __name__ == "__main__":
    main()
