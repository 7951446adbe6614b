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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.core.device import resolve_device
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


def state_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """What a checkpoint holds of a train state: the weights by name, the
    optimizer's state and the step."""
    return {"params": {n: p.detach()
                       for n, p in state["model"].named_parameters()},
            "opt": state["opt"], "step": state["step"]}


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
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.run_cfg = run_cfg
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tcfg)
        self.ckpt = CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep)
        self.metrics_log: List[Dict[str, float]] = []
        self.sketcher = ActivationSketcher(device=self.device) \
            if run_cfg.monitor_activations else None

        gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
        self.state = init_train_state(cfg, tcfg, gen, device=self.device)
        start = latest_step(run_cfg.ckpt_dir)
        self.start_step = 0
        if start is not None:
            tree = restore_checkpoint(run_cfg.ckpt_dir, start,
                                      state_tree(self.state))
            self.state = load_state_tree(self.state, tree)
            self.start_step = start

    def run(self) -> Dict[str, Any]:
        rc = self.run_cfg
        t0 = time.time()
        step = self.start_step
        try:
            while step < rc.total_steps:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                if self.sketcher is not None and step % rc.log_every == 0:
                    # monitor input embeddings as a cheap residual proxy
                    self.sketcher.observe(
                        self.state["model"].embed.detach()[
                            batch["tokens"][:1]])
                if step % rc.log_every == 0 or step == rc.total_steps:
                    row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = step
                    self.metrics_log.append(row)
                if step % rc.ckpt_every == 0 or step == rc.total_steps:
                    self.ckpt.save(step, state_tree(self.state))
        finally:
            self.ckpt.wait()
            self.ckpt.close()
        out = {"final_step": step, "wall_s": time.time() - t0,
               "metrics": self.metrics_log}
        if self.sketcher is not None:
            out["activation_report"] = {
                k: v for k, v in self.sketcher.report().items()
                if k not in ("hh", "grid")}
        return out
