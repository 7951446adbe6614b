"""Train and serving step factories (the port of ``repro.train.steps``):

* ``make_train_step``   — forward + loss + backward + AdamW/Adafactor;
* ``make_prefill_step`` — prompt → filled caches + first-token logits;
* ``make_decode_step``  — one token against the cache (+ SSM states);
* ``make_batch_specs``, ``make_decode_specs``, ``param_specs``,
  ``train_state_specs`` — their inputs as tensors on the ``meta`` device
  (shapes and dtypes, nothing allocated), whole or one rank's blocks,
  which ``launch/dryrun.py`` runs the steps on.

Plain callables on the model's device.  A train state is ``{"model": LM,
"opt": AdamWState | AdafactorState, "step": int}``; the step updates the
weights and the optimizer's state in place and returns the state.

On a mesh (``init_train_state(mesh=)``) each rank holds its blocks of the
weights (``launch.sharding.shard_model``), takes its rows of the batch,
and the step computes what one device's step computes on the whole
batch; the step reads the mesh and the layouts from the model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.core import mesh as mesh_mod
from repro_torch.launch import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdafactorConfig, AdamWConfig, adafactor_init,
                               adafactor_update, adamw_init, adamw_update,
                               cosine_schedule)

TrainState = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: str = "adamw"          # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    q_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots


def init_optimizer(cfg: ModelConfig, tcfg: TrainStepConfig,
                   model: model_mod.LM):
    """The optimizer's zero state for ``model``'s weights (a sharded
    model's blocks: AdamW's moments as the blocks, Adafactor's statistics
    of the full leaves)."""
    params = dict(model.named_parameters())
    if tcfg.optimizer == "adamw":
        return adamw_init(params)
    shapes = None
    if getattr(model, "par", None) is not None:
        shapes = {n: sh.full_shape(p.shape, model.specs[n], model.par.mesh)
                  for n, p in params.items()}
    return adafactor_init(params, stacks=model_mod.param_stacks(cfg, model),
                          shapes=shapes)


def init_train_state(cfg: ModelConfig, tcfg: TrainStepConfig,
                     generator: torch.Generator, device=None, tp: int = 1,
                     mesh=None, policy: Optional[sh.ShardingPolicy] = None
                     ) -> TrainState:
    """Weights drawn from ``generator`` on ``device`` (the card unless the
    caller names another), the optimizer's zero state, step 0.  With a
    ``mesh``: this rank's blocks of the weights under ``policy``, each
    part cut as soon as it is drawn (``models.model.init_params``)."""
    model = model_mod.init_params(cfg, generator, tp=tp, device=device,
                                  mesh=mesh, policy=policy)
    model.requires_grad_(True)
    return {"model": model, "opt": init_optimizer(cfg, tcfg, model),
            "step": 0}


GRAD_BUCKET_BYTES = 1 << 28     # gradients summed in one collective, at most


@torch.no_grad()
def sync_grads(grads: Dict[str, torch.Tensor], specs: Mapping[str, Any],
               mesh) -> Dict[str, torch.Tensor]:
    """Sum each gradient over the data axes its leaf is replicated on, in
    place.  An FSDP leaf's gradient comes out of the backward pass
    already reduce-scattered over "data" (the gather's adjoint); a
    leaf replicated over "model" gets its whole gradient on every model
    rank.  Leaves that sum over the same axes share a collective, up to
    GRAD_BUCKET_BYTES."""
    from repro_torch.launch.mesh import dp_axes
    dp = dp_axes(mesh)
    buckets: Dict[Any, list] = {}
    for n, g in grads.items():
        split = set(sh.spec_axes(specs[n]))
        axes = tuple(a for a in dp if a not in split
                     and mesh_mod.axis_size(mesh, a) > 1)
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(n)
    for (axes, _), names in buckets.items():
        start = 0
        while start < len(names):
            group, size = [], 0
            for n in names[start:]:
                nbytes = grads[n].numel() * grads[n].element_size()
                if group and size + nbytes > GRAD_BUCKET_BYTES:
                    break
                group.append(n)
                size += nbytes
            start += len(group)
            flat = mesh_mod.all_reduce(
                torch.cat([grads[n].reshape(-1) for n in group]), mesh, axes)
            off = 0
            for n in group:
                k = grads[n].numel()
                grads[n].copy_(flat[off:off + k].view_as(grads[n]))
                off += k
    return grads


def make_train_step(cfg: ModelConfig,
                    tcfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss and
    its backward, the cosine schedule's rate for the step, then AdamW
    (metrics' ``grad_norm`` the pre-clip norm) or Adafactor
    (``grad_norm`` 0).  Metrics are tensors: ``loss``, ``lb_loss``,
    ``z_loss``, ``grad_norm``, ``lr``, ``total_loss`` (and an MoE
    model's ``dropped_frac``, the mean over its MoE layers).

    A sharded model (``sharding.shard_model``) takes this rank's rows of
    the batch; its gradients leave the backward pass in the parameters'
    layout (the model's ``specs``): reduce-scattered over "data" on FSDP
    leaves, then summed over every data axis a leaf is replicated on
    (:func:`sync_grads`)."""
    if tcfg.optimizer == "adamw":
        ocfg = AdamWConfig(lr=tcfg.peak_lr)
    elif tcfg.optimizer == "adafactor":
        ocfg = AdafactorConfig(lr=tcfg.peak_lr)
    else:
        raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state["model"].requires_grad_(True)
        par = getattr(model, "par", None)
        mesh = None if par is None else par.mesh
        specs = None if par is None else model.specs
        model.zero_grad(set_to_none=True)
        total, metrics = model_mod.forward_train(
            cfg, model, batch, q_chunk=tcfg.q_chunk, remat=tcfg.remat,
            remat_policy=tcfg.remat_policy)
        total.backward()
        params = dict(model.named_parameters())
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        if mesh is not None:
            sync_grads(grads, specs, mesh)
        lr = cosine_schedule(state["step"], tcfg.warmup_steps,
                             tcfg.total_steps, tcfg.peak_lr)
        if tcfg.optimizer == "adamw":
            _, opt, gnorm = adamw_update(grads, state["opt"], params, ocfg,
                                         lr=float(lr), mesh=mesh,
                                         specs=specs)
        else:
            _, opt = adafactor_update(
                grads, state["opt"], params, ocfg, lr=float(lr),
                stacks=model_mod.param_stacks(cfg, model), mesh=mesh,
                specs=specs)
            gnorm = torch.zeros(())
        del grads
        model.zero_grad(set_to_none=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, lr=lr, total_loss=total.detach())
        return {"model": model, "opt": opt, "step": state["step"] + 1}, \
            metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, tp: int = 1,
                      mesh=None, policy: Optional[sh.ShardingPolicy] = None
                      ) -> Callable:
    """``prefill(model, batch) -> (logits (B, V), decode_state)``; ``batch``
    holds ``tokens`` (B, S) and, by family, ``patch_embeds`` (vlm) or
    ``src_embeds`` (encoder-decoder).

    With a ``mesh`` the model is a rank's blocks (``init_params(mesh=)``),
    ``batch`` the whole batch on every rank, and the step takes the rank's
    rows of it (``sharding.decode_layout``): it returns their logits and
    the rank's blocks of the decode state, cut under ``policy`` as they
    are allocated."""

    @torch.inference_mode()
    def prefill(model: model_mod.LM, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        state = model_mod.init_decode_state(cfg, tokens.shape[0], cache_len,
                                            tp=tp, device=tokens.device,
                                            mesh=mesh, policy=policy)
        lay = state.get("layout")
        if lay is not None:
            batch = {k: lay.rows(v) for k, v in batch.items()}
        prefix = batch.get("patch_embeds") if cfg.frontend == "vision" \
            else None
        if cfg.encoder_layers:
            enc_out = model_mod.encode(cfg, model, batch["src_embeds"])
            state = model_mod.fill_cross_caches(cfg, model, state, enc_out)
        return model_mod.forward_step(cfg, model, batch["tokens"], state,
                                      prefix_embeds=prefix)

    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(model, token (B, 1), state) -> (logits, state)``: one new
    token against the existing KV/SSM caches, written in place.  On a
    mesh ``token`` holds the rank's rows (those of its prefill's
    logits); the state says how it is cut."""

    @torch.inference_mode()
    def decode(model: model_mod.LM, token: torch.Tensor, state):
        return model_mod.forward_step(cfg, model, token, state)

    return decode


# ======================================================== meta stand-ins
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """A training/prefill batch of one shape cell as ``meta`` tensors, in
    the reference's dtypes (int32 tokens and labels, an f32 loss mask);
    with a ``mesh`` this rank's rows (``sharding.batch_pspecs``)."""
    prefix = cfg.num_prefix if cfg.frontend == "vision" else 0
    text = (global_batch, seq_len - prefix)
    out = {"tokens": _meta(text, torch.int32),
           "labels": _meta(text, torch.int32),
           "loss_mask": _meta(text, torch.float32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = _meta((global_batch, cfg.num_prefix,
                                     cfg.d_model), cfg.pdtype)
    if cfg.encoder_layers:
        out["src_embeds"] = _meta((global_batch, seq_len, cfg.d_model),
                                  cfg.pdtype)
    if mesh is not None:
        specs = sh.batch_pspecs(out, mesh)
        out = {k: sh.local_shard(v, specs[k], mesh) for k, v in out.items()}
    return out


def make_decode_specs(cfg: ModelConfig, global_batch: int, cache_len: int,
                      tp: int = 1, mesh=None,
                      policy: Optional[sh.ShardingPolicy] = None):
    """(the token (B, 1) int32, the decode state) of one decode cell as
    ``meta`` tensors; with a ``mesh`` this rank's rows and blocks
    (``init_decode_state(mesh=)``)."""
    token = _meta((global_batch, 1), torch.int32)
    state = model_mod.init_decode_state(cfg, global_batch, cache_len, tp=tp,
                                        device="meta", mesh=mesh,
                                        policy=policy)
    if mesh is not None:
        token = state["layout"].rows(token)
    return token, state


def param_specs(cfg: ModelConfig, tp: int = 1, mesh=None,
                policy: Optional[sh.ShardingPolicy] = None
                ) -> model_mod.LM:
    """The model's parameters on ``meta`` (nothing drawn); with a
    ``mesh`` cut to this rank's blocks under ``policy``, heads and
    vocabulary padded by its "model" size."""
    if mesh is not None:
        from repro_torch.launch.mesh import tp_size
        tp = max(tp, tp_size(mesh))
    model = model_mod.LM(cfg, tp, device="meta")
    if mesh is not None:
        sh.shard_model(model, mesh, policy or sh.ShardingPolicy())
    return model


def train_state_specs(cfg: ModelConfig, tcfg: TrainStepConfig, tp: int = 1,
                      mesh=None, policy: Optional[sh.ShardingPolicy] = None
                      ) -> TrainState:
    """:func:`init_train_state`'s state on ``meta``: the model (with
    gradients on), the optimizer's zero state, step 0."""
    model = param_specs(cfg, tp, mesh, policy).requires_grad_(True)
    return {"model": model, "opt": init_optimizer(cfg, tcfg, model),
            "step": 0}
