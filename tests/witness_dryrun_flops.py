"""The dry run's dot FLOPs against the JAX reference's, every SMOKE config
in a train, a prefill and a decode cell (not collected by pytest):

    PYTHONPATH=src python tests/witness_dryrun_flops.py [--batch 2] [--seq 32]

For each cell: the port's count (``launch.dryrun.cost_step`` on a (1, 1)
mesh: ``FlopCounterMode`` over the step on the meta device), the
reference's (``hlo_analysis.analyze_hlo`` on its step lowered and
compiled for one CPU device), their ratio, and the model FLOPs (2·N_active
a token, 6· for training).  CPU only, about a minute.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

KINDS = ("train", "prefill", "decode")


def reference_flops(rc, kind: str, batch: int, seq: int) -> float:
    """``analyze_hlo``'s dot FLOPs of the reference's step for one CPU
    device (weights and inputs as ShapeDtypeStructs)."""
    import jax
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.train import steps as rs
    if kind == "train":
        tcfg = rs.TrainStepConfig(q_chunk=min(1024, seq))
        args = (rs.train_state_specs(rc, tcfg),
                rs.make_batch_specs(rc, batch, seq))
        fn = rs.make_train_step(rc, tcfg)
    elif kind == "prefill":
        b = rs.make_batch_specs(rc, batch, seq)
        b = {k: v for k, v in b.items() if k not in ("labels", "loss_mask")}
        args = (rs.param_specs(rc), b)
        fn = rs.make_prefill_step(rc, seq)
    else:
        token, state = rs.make_decode_specs(rc, batch, seq)
        args = (rs.param_specs(rc), token, state)
        fn = rs.make_decode_step(rc)
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return analyze_hlo(hlo)["flops"]


def port_flops(pc, kind: str, batch: int, seq: int) -> float:
    from repro_torch.launch import dryrun
    return dryrun.cost_step(pc, kind, batch, seq, (1, 1),
                            ("data", "model"))["flops"]


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    n = cfg.active_param_count()
    return {"train": 6 * n * batch * seq, "prefill": 2 * n * batch * seq,
            "decode": 2 * n * batch}[kind]


def smoke_pair(arch: str):
    """(reference, port) SMOKE configs of ``arch`` in f32."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    def cast(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32")
    return cast(ref_config(arch, smoke=True)), cast(get_config(arch,
                                                               smoke=True))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    from repro_torch.configs import ARCH_IDS
    print("| arch | cell | port | reference | port / reference | "
          "model FLOPs |")
    print("|---|---|---|---|---|---|")
    for arch in ARCH_IDS:
        rc, pc = smoke_pair(arch)
        for kind in KINDS:
            p = port_flops(pc, kind, args.batch, args.seq)
            r = reference_flops(rc, kind, args.batch, args.seq)
            print(f"| {arch} | {kind} B {args.batch} S {args.seq} | {p:.6g} "
                  f"| {r:.6g} | {p / r:.4f} | "
                  f"{model_flops(pc, kind, args.batch, args.seq):.6g} |",
                  flush=True)


if __name__ == "__main__":
    main()
