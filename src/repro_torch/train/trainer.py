"""Trainer: a checkpointed training loop with fault-injection hooks (the
port of ``repro.train.trainer``).

* the state is one train state (``train.steps``), updated in place by
  the step;
* checkpoints every ``ckpt_every`` steps (and at the end) through the
  async ``CheckpointManager`` (atomic rename, retention, torn steps
  skipped on restart), resumed from ``latest_step``;
* ``fault_hook(step)`` may raise before a step (tests kill the trainer at
  a step and hold the restarted run to an uninterrupted one, bit for
  bit);
* an optional Sketch-and-Scale activation monitor.

On a mesh (``Trainer(mesh=, policy=)``; every rank builds one) each rank
holds its blocks of the train state, takes its rows of ``batch_fn``'s
global batch, and the checkpoint is the gathered state written by rank
0, in the single-device format: it restores onto any mesh or one
device, and onto the same mesh bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.core.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.train.callbacks import ActivationSketcher
from repro_torch.train.steps import (TrainStepConfig, init_train_state,
                                     make_train_step)


@dataclasses.dataclass(kw_only=True)
class TrainerConfig:
    ckpt_dir: str                  # the run's own: a rerun resumes there
    total_steps: int = 100
    ckpt_every: int = 20
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    monitor_activations: bool = False


def state_tree(state: Dict[str, Any], full: bool = False) -> Dict[str, Any]:
    """What a checkpoint holds of a train state: the weights by name, the
    optimizer's state and the step.  ``full``: a sharded state's leaves
    gathered whole onto the host, one leaf at a time, so that the card
    holds one full leaf at most (a collective: every rank of the mesh
    calls it)."""
    model = state["model"]
    tree = {"params": {n: p.detach() for n, p in model.named_parameters()},
            "opt": state["opt"], "step": state["step"]}
    par = getattr(model, "par", None)
    if not full or par is None:
        return tree
    specs = model.specs

    def whole(leaves):
        return {n: sh.gather_full(t, specs[n], par.mesh).cpu()
                for n, t in leaves.items()}
    opt = state["opt"]
    if hasattr(opt, "m"):                # Adafactor's statistics are whole
        opt = opt._replace(m=whole(opt.m), v=whole(opt.v))
    return {"params": whole(tree["params"]), "opt": opt,
            "step": state["step"]}


@torch.no_grad()
def load_state_tree(state: Dict[str, Any], tree: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """Copy a restored :func:`state_tree` into ``state``'s weights; its
    optimizer state and step replace ``state``'s."""
    for n, p in state["model"].named_parameters():
        p.copy_(tree["params"][n])
    return dict(state, opt=tree["opt"], step=tree["step"])


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainStepConfig,
                 run_cfg: TrainerConfig,
                 batch_fn: Callable[[int], Dict[str, torch.Tensor]],
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device=None, mesh=None,
                 policy: Optional[sh.ShardingPolicy] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.run_cfg = run_cfg
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self.mesh = mesh
        self.step_fn = make_train_step(cfg, tcfg)
        self.writer = mesh is None or torch.distributed.get_rank() == 0
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep) \
            if self.writer else None
        self.metrics_log: List[Dict[str, float]] = []
        self.sketcher = ActivationSketcher(device=self.device) \
            if run_cfg.monitor_activations else None

        gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
        self.state = init_train_state(cfg, tcfg, gen, device=self.device,
                                      mesh=mesh, policy=policy)
        start = self._agreed(latest_step(run_cfg.ckpt_dir))
        self.start_step = 0
        if start is not None:
            tree = restore_checkpoint(
                run_cfg.ckpt_dir, start, state_tree(self.state),
                shardings=None if mesh is None
                else sh.train_state_pspecs(self.state), mesh=mesh)
            self.state = load_state_tree(self.state, tree)
            self.start_step = start

    def _agreed(self, step: Optional[int]) -> Optional[int]:
        """Rank 0's newest complete step, on every rank of the mesh."""
        if self.mesh is None:
            return step
        box = [step]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def _local(self, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return batch
        specs = sh.batch_pspecs(batch, self.mesh)
        return {k: sh.local_shard(v, specs[k], self.mesh).to(self.device)
                for k, v in batch.items()}

    def _save(self, step: int) -> None:
        tree = state_tree(self.state, full=self.mesh is not None)
        if self.writer:
            self.ckpt.save(step, tree)

    def run(self) -> Dict[str, Any]:
        rc = self.run_cfg
        t0 = time.time()
        step = self.start_step
        try:
            while step < rc.total_steps:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self._local(self.batch_fn(step))
                self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                if self.sketcher is not None and step % rc.log_every == 0:
                    # monitor input embeddings as a cheap residual proxy
                    with torch.no_grad():
                        self.sketcher.observe(model_mod.embed_rows(
                            self.state["model"], batch["tokens"][:1]))
                if step % rc.log_every == 0 or step == rc.total_steps:
                    row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = step
                    self.metrics_log.append(row)
                if step % rc.ckpt_every == 0 or step == rc.total_steps:
                    self._save(step)
        finally:
            if self.ckpt is not None:
                self.ckpt.wait()
                self.ckpt.close()
        if self.mesh is not None:        # every rank sees the last commit
            torch.distributed.barrier()
        out = {"final_step": step, "wall_s": time.time() - t0,
               "metrics": self.metrics_log}
        if self.sketcher is not None and self.mesh is not None:
            from repro_torch.launch.mesh import dp_axes
            self.sketcher._sk = self.sketcher.merged(
                mesh=self.mesh, axes=tuple(reversed(dp_axes(self.mesh))))
        if self.sketcher is not None:
            out["activation_report"] = {
                k: v for k, v in self.sketcher.report().items()
                if k not in ("hh", "grid")}
        return out
