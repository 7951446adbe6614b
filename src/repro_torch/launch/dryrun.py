"""Dry run of the LM stack: one rank's step of every (arch × shape × mesh)
cell, costed on the ``meta`` device.  The port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for the production mesh and
reads the compiled program: memory analysis, cost analysis, collective
bytes and a trip-count-aware FLOP count of its HLO.  The port has no
compiler to ask.  It runs the step itself, as the program of one rank of
that mesh, on tensors of the ``meta`` device (shapes and dtypes, nothing
allocated or computed) in a process whose default group is a fake one of
the mesh's size (``torch.testing``'s ``FakeStore``, backend ``"fake"``:
its collectives complete at once and move nothing).  The same code and
the same shapes as a real step, so:

* dot FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step
  (matmuls, batched matmuls, attention's products; the backward pass and
  remat's recompute included);
* collective bytes by kind, in all and across hosts of 8 ranks
  (``core.mesh.HOST_RANKS``):
  ``core.mesh.count_collectives`` over the step, the reference's
  result-shape convention;
* memory: the argument, output and donated (alias) bytes of the rank's
  blocks.  ``temp_bytes`` is ``None``: the meta device allocates nothing,
  so a step's temporaries are seen only on the card;
* ``bytes``: the sum over the step's ops of their operands' and results'
  bytes (:class:`OpBytes`), every op unfused: the counterpart of the
  reference's HLO byte count, an upper bound on a step's HBM traffic.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
    python -m repro_torch.launch.dryrun --all --both-meshes

One JSON record per cell (existing files are kept unless ``--force``).
Runs on the CPU; no card, no process besides this one.  The fake group
is this process's default group while a cell runs, so the dry run never
runs inside a rank that has joined a real group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import mesh as mesh_mod
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models.config import SHAPES, ModelConfig, shape_applicable
from repro_torch.train import steps

TEMP_REASON = ("the meta device allocates nothing: a step's temporaries "
               "are measured on the card, not in the dry run")


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """This process's default group, for the duration: a fake one of
    ``world`` ranks in which it is ``rank``.  Raises when a group is
    already up (a rank of a real mesh must not run the dry run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: "
                           "torch.distributed already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class OpBytes:
    """Context: the sum over every op dispatched while open of its tensor
    operands' and results' bytes (views and metadata ops included as
    their sizes), ``total``."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                outer.total += _nbytes(tree_leaves((args, kwargs, out)))
                return out
        self.total = 0
        self.mode = _Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _state_tensors(state) -> list:
    return [t for g in ("layers", "cross") for c in state.get(g, ())
            for t in c.values()]


def cost_step(cfg: ModelConfig, kind: str, global_batch: int, seq_len: int,
              shape: Sequence[int], names: Sequence[str], *, rank: int = 0,
              policy: Optional[sh.ShardingPolicy] = None,
              remat_policy: str = "nothing") -> Dict[str, Any]:
    """One step of ``kind`` ("train", "prefill" or "decode") of ``cfg`` at
    ``global_batch`` × ``seq_len`` as rank ``rank`` of a mesh of ``shape``
    named ``names``, on the meta device under a fake group: a train step
    (AdamW, remat) on the rank's rows; a prefill of ``seq_len`` tokens
    (the vlm's patch prefix among them) into a cache of ``seq_len``
    slots; a decode step against a full cache of ``seq_len`` slots.
    Returns ``{"flops", "bytes", "collectives", "calls", "memory",
    "param_count_local"}`` (see the module docstring; ``calls`` are
    ``count_collectives``' entries, in order)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode
    pol = policy or sh.ShardingPolicy()
    world = math.prod(shape)
    with fake_group(world, rank):
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(tuple(shape)),
                          mesh_dim_names=tuple(names))
        if kind == "train":
            tcfg = steps.TrainStepConfig(remat_policy=remat_policy,
                                         q_chunk=min(1024, seq_len))
            state = steps.train_state_specs(cfg, tcfg, mesh=mesh,
                                            policy=pol)
            batch = steps.make_batch_specs(cfg, global_batch, seq_len, mesh)
            params = list(state["model"].parameters())
            opt = list(state["opt"].m.values()) + list(state["opt"].v.values())
            args = _nbytes(params) + _nbytes(opt) + _nbytes(batch.values())
            alias = _nbytes(params) + _nbytes(opt)
            outputs = alias
            fn = steps.make_train_step(cfg, tcfg)

            def run():
                fn(state, batch)
        else:
            model = steps.param_specs(cfg, mesh=mesh, policy=pol)
            params = list(model.parameters())
            if kind == "prefill":
                batch = steps.make_batch_specs(cfg, global_batch, seq_len)
                batch = {k: v for k, v in batch.items()
                         if k not in ("labels", "loss_mask")}
                fn = steps.make_prefill_step(cfg, seq_len, mesh=mesh,
                                             policy=pol)
                lay = sh.decode_layout(mesh, global_batch, seq_len, pol)
                inputs = [lay.rows(v) for v in batch.values()]
                _, out_state = steps.make_decode_specs(
                    cfg, global_batch, seq_len, mesh=mesh, policy=pol)
                args = _nbytes(params) + _nbytes(inputs)
                alias = 0

                def run():
                    return fn(model, batch)
            elif kind == "decode":
                token, state = steps.make_decode_specs(
                    cfg, global_batch, seq_len, mesh=mesh, policy=pol)
                state["pos"] = seq_len - 1
                out_state = state
                fn = steps.make_decode_step(cfg)
                args = _nbytes(params) + _nbytes([token]) + _nbytes(
                    _state_tensors(state))
                alias = _nbytes(_state_tensors(state))

                def run():
                    return fn(model, token, state)
            else:
                raise ValueError(f"unknown step kind {kind!r}")
            rows = out_state["layout"].rows(
                torch.empty((global_batch,), device="meta")).shape[0]
            v = sh.full_shape(model.head.shape, model.specs[
                "embed" if model.lm_head is None else "lm_head"], mesh)[0]
            outputs = rows * v * 4 + _nbytes(_state_tensors(out_state))
        with FlopCounterMode(display=False) as flops, \
                mesh_mod.count_collectives() as coll, \
                OpBytes() as moved:
            run()
        local = sum(p.numel() for p in params)
    return {"flops": float(flops.get_total_flops()), "bytes": moved.total,
            "collectives": coll.summary(), "calls": coll.calls,
            "memory": {"argument_bytes": args, "output_bytes": outputs,
                       "alias_bytes": alias, "temp_bytes": None,
                       "temp_bytes_reason": TEMP_REASON},
            "param_count_local": local}


def record(cfg: ModelConfig, kind: str, global_batch: int, seq_len: int,
           shape: Sequence[int], names: Sequence[str], **kw
           ) -> Dict[str, Any]:
    """:func:`cost_step`'s numbers as a record in the reference's form
    (``collectives`` and the trip-count-aware ``counts`` that
    ``launch/roofline.py`` reads), plus the cell's sizes and each
    collective call (``calls``)."""
    t0 = time.time()
    c = cost_step(cfg, kind, global_batch, seq_len, shape, names, **kw)
    coll = c["collectives"]
    return {
        "status": "ok",
        "dryrun_s": round(time.time() - t0, 1),
        "memory": c["memory"],
        "collectives": {"per_kind": coll["per_kind"], "total": coll["total"],
                        "dcn": coll["cross_host"],
                        "num_ops": coll["num_ops"]},
        "counts": {"flops": c["flops"], "bytes": float(c["bytes"]),
                   "collective_bytes": coll["total"],
                   "collective_dcn_bytes": coll["cross_host"],
                   "collective_ops": coll["num_ops"],
                   "per_kind": coll["per_kind"]},
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "param_count_local": c["param_count_local"],
        "calls": c["calls"],
        "global_batch": global_batch,
        "seq_len": seq_len,
        "kind": kind,
        "devices": math.prod(shape),
        "mesh_shape": list(shape),
        "mesh_axes": list(names),
        "tp": dict(zip(names, shape)).get("model", 1),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: Optional[sh.ShardingPolicy] = None,
             remat_policy: str = "nothing",
             capacity_factor: Optional[float] = None) -> Dict[str, Any]:
    """One production cell: ``arch`` at ``SHAPES[shape_name]`` on rank 0
    of the (16, 16) mesh, or (2, 16, 16) with ``multi_pod``; a cell that
    ``shape_applicable`` refuses is recorded as skipped with its reason."""
    pol = policy or sh.ShardingPolicy()
    cfg = get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shp = SHAPES[shape_name]
    mesh_shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": "(2,16,16)" if multi_pod else "(16,16)"}
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    rec["policy"] = {"act_mode": pol.act_mode, "fsdp": pol.fsdp,
                     "remat_policy": remat_policy}
    try:
        rec.update(record(cfg, shp.kind, shp.global_batch, shp.seq_len,
                          mesh_shape, names, policy=pol,
                          remat_policy=remat_policy))
        del rec["calls"]
    except Exception as e:                                   # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--act-mode", default="embed_tp",
                    choices=sh.ACT_MODES)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=("nothing", "dots"))
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    policy = sh.ShardingPolicy(fsdp=not args.no_fsdp, act_mode=args.act_mode)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        pods = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(a, s, mp) for a in ARCH_IDS for s in SHAPES for mp in pods]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required without --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'2pod' if mp else '1pod'}"
        if args.tag:
            tag += f"__{args.tag}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        rec = run_cell(arch, shape, mp, policy=policy,
                       remat_policy=args.remat_policy,
                       capacity_factor=args.capacity_factor)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        extra = ""
        if rec["status"] == "ok":
            extra = (f" flops={rec['counts']['flops']:.3e} "
                     f"coll={rec['collectives']['total']:.3e}B "
                     f"{rec['dryrun_s']}s")
        elif rec["status"] == "error":
            extra = " " + rec["error"][:200]
        print(f"[{rec['status']}] {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()
