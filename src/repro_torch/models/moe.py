"""Mixture-of-Experts: token-choice top-k router with capacity, sort-based
dispatch with static shapes.  The port of ``repro.models.moe``.

The N·K (token, expert, gate) assignments are sorted by expert id
(stable, so router order decides who is dropped), each gets its position
within its expert's run, those at or past the capacity C are dropped,
and the kept ones fill an (E·C,) slot table.  The expert FFN runs as
batched matmuls over (E, C, D); the gated results come back to their
tokens.

Orders the reference fixes and the port keeps:

* ``lax.top_k`` puts the lower expert first among equal router
  probabilities (``candidates.topk_desc`` along the expert axis);
* the combine ``out.at[gather_idx].add`` accumulates in the activation
  dtype, in slot order (ascending expert id for one token).  The port
  adds a token's kept assignments in that order, one pass a rank, so the
  card gives the same bits on every run (an ``index_add_`` of bf16 rows
  on CUDA adds in whatever order its atomics land).

On a mesh (``par`` set by ``launch.sharding.shard_model``) the batch is
split over the data axes and the experts over "model" (EP), the router
replicated over "model".  The capacity stays the reference's global one:
C is that of every token of the global batch, and an assignment's
position in its expert's run is its rank's exclusive prefix of the
per-expert counts over the data ranks (in batch order) plus its local
position, so the same assignments are dropped as on one device.  Each
model rank runs its experts' FFN and combines their share of a token's
output; the shares are summed over "model".  The aux losses' means are
over the global batch: their sums are summed over the data axes before
the product.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import mesh as mesh_mod
from repro_torch.core.candidates import topk_desc
from repro_torch.launch.sharding import shard_moe_dispatch
from repro_torch.models.layers import _normal_, _param, silu


class Moe(nn.Module):
    """router (D, E) f32 whatever the param dtype; w_gate, w_up (E, D, F);
    w_down (E, F, D)."""

    def __init__(self, d_model: int, num_experts: int, expert_ff: int,
                 dtype, device=None):
        super().__init__()
        self.par = None
        self.router = _param((d_model, num_experts), torch.float32, device)
        self.w_gate = _param((num_experts, d_model, expert_ff), dtype, device)
        self.w_up = _param((num_experts, d_model, expert_ff), dtype, device)
        self.w_down = _param((num_experts, expert_ff, d_model), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        d_model, expert_ff = self.w_gate.shape[1:]
        si = float(1.0 / math.sqrt(d_model))
        _normal_(self.router, gen, si)
        _normal_(self.w_gate, gen, si)
        _normal_(self.w_up, gen, si)
        _normal_(self.w_down, gen, float(1.0 / math.sqrt(expert_ff)))


def capacity(num_tokens: int, num_experts: int, top_k: int,
             factor: float) -> int:
    c = int(np.ceil(num_tokens * top_k * factor / num_experts))
    return max(8, ((c + 7) // 8) * 8)       # the reference's multiple of 8


class MoeAux(NamedTuple):
    load_balance_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped_frac: torch.Tensor   # fraction of assignments over capacity


class Routing(NamedTuple):
    """What :func:`moe_apply` routed by, for :func:`moe_aux`."""
    logits: torch.Tensor         # (N, E) f32 router logits
    probs: torch.Tensor          # (N, E) f32
    expert_ids: torch.Tensor     # (N, K) chosen experts, best first
    keep: torch.Tensor           # (N·K,) bool: assignment within capacity


def moe_aux(r: Routing, par=None) -> MoeAux:
    """The reference's aux losses (load balance, router z, dropped share)
    from a routing: computed only for a caller that trains on them.  With
    ``par`` (the sharded layer's mesh) the routing is this data rank's and
    every mean is over the global batch."""
    e = r.probs.shape[1]
    if par is None or mesh_mod.axis_size(par.mesh, par.dp) == 1:
        f = torch.mean(F.one_hot(r.expert_ids[:, 0], e).float(), dim=0)
        lb = e * torch.sum(f * torch.mean(r.probs, dim=0))
        z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
        dropped = 1.0 - torch.sum(r.keep) / r.keep.numel()
        return MoeAux(load_balance_loss=lb, z_loss=z, dropped_frac=dropped)
    n = r.probs.shape[0] * mesh_mod.axis_size(par.mesh, par.dp)
    top1 = mesh_mod.all_reduce(
        torch.sum(F.one_hot(r.expert_ids[:, 0], e).float(), dim=0),
        par.mesh, par.dp)
    f = top1 / n
    lb = e * torch.sum(f * (par.dp_sum(torch.sum(r.probs, dim=0)) / n))
    z = par.dp_sum(torch.sum(torch.logsumexp(r.logits, dim=-1) ** 2)) / n
    kept = mesh_mod.all_reduce(torch.sum(r.keep, dtype=torch.float32),
                               par.mesh, par.dp)
    dropped = 1.0 - kept / (r.keep.numel() * (n // r.probs.shape[0]))
    return MoeAux(load_balance_loss=lb, z_loss=z, dropped_frac=dropped)


def _global_positions(par, se: torch.Tensor, pos: torch.Tensor, e: int
                      ) -> torch.Tensor:
    """Each sorted assignment's position in its expert's run over the
    global batch: the data ranks before this one (in batch order) hold
    the first tokens, so their counts of each expert come first."""
    counts = torch.zeros((1, e), dtype=torch.long, device=se.device
                         ).scatter_add_(1, se[None], torch.ones_like(se)[None])
    every = mesh_mod.all_gather_dim(counts, par.mesh, par.dp, 0)
    me = mesh_mod.linear_index(par.mesh, par.dp)
    return pos + every[:me].sum(dim=0)[se]


def moe_apply(p: Moe, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, par=None
              ) -> Tuple[torch.Tensor, Routing]:
    """x (B, S, D) -> (B, S, D) and its routing (the reference's aux
    losses are ``moe_aux(routing)``).  Static shapes throughout.  ``par``
    overrides the layer's own mesh context: a decode step whose batch is
    not split over the data axes passes one whose ``dp`` is empty, so the
    capacity counts its tokens once."""
    b, s, d = x.shape
    n = b * s
    e = p.router.shape[1]
    par = p.par if par is None else par
    n_dp = 1 if par is None else mesh_mod.axis_size(par.mesh, par.dp)
    c = capacity(n * n_dp, e, top_k, capacity_factor)
    dev = x.device
    xf = x.reshape(n, d)

    logits = xf.float() @ p.router                        # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = topk_desc(probs, top_k)        # (N, K)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- sort-based dispatch ---------------------------------------------
    flat_expert = expert_ids.reshape(-1)                   # (N*K,)
    flat_token = torch.arange(n, device=dev).repeat_interleave(top_k)
    se, order = torch.sort(flat_expert, stable=True)
    st, sg = flat_token[order], gate_vals.reshape(-1)[order]
    idx = torch.arange(n * top_k, device=dev)
    head = torch.ones_like(se, dtype=torch.bool)
    head[1:] = se[1:] != se[:-1]
    run_start = torch.cummax(torch.where(head, idx, 0), dim=0).values
    pos_in_expert = idx - run_start
    keep = (pos_in_expert if n_dp == 1 else
            _global_positions(par, se, pos_in_expert, e)) < c
    slot = torch.where(keep, se * c + pos_in_expert, e * c)   # e*c: trash
    if par is not None:                 # rank-local work: shares' gradients
        xf, sg = par.to_tp(xf), par.to_tp(sg)

    slot_token = torch.zeros(e * c + 1, dtype=torch.long, device=dev
                             ).scatter_(0, slot, st)
    slot_filled = torch.zeros(e * c + 1, dtype=torch.bool, device=dev
                              ).scatter_(0, slot, keep)
    gather_idx, filled = slot_token[:e * c], slot_filled[:e * c]
    xe = torch.where(filled[:, None], xf[gather_idx], 0).reshape(e, c, d)
    xe = shard_moe_dispatch(xe, par)                       # EP: (E_l, C, D)
    el = xe.shape[0]
    e0 = 0 if par is None or par.tp is None else par.tp_block(e)[0]

    # ---- expert FFN (batched over this rank's experts) -------------------
    h = silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    ye = torch.bmm(h, p.w_down)                            # (E_l, C, D)

    # ---- combine: each token's kept slots, ascending, gate-weighted ------
    slot_gate = torch.zeros(e * c + 1, dtype=torch.float32, device=dev
                            ).scatter_(0, slot, torch.where(keep, sg, 0.0))
    slot_gate = slot_gate[e0 * c:(e0 + el) * c]
    gated = ye.reshape(el * c, d) * slot_gate[:, None].to(ye.dtype)
    gated = torch.cat([gated, gated.new_zeros(1, d)])      # last row adds 0
    token_slots = torch.empty_like(slot).scatter_(0, order, slot)
    token_slots = torch.sort(token_slots.reshape(n, top_k), dim=-1).values
    if el != e:                         # other ranks' experts: the zero row
        local = token_slots - e0 * c
        token_slots = torch.where((local >= 0) & (local < el * c), local,
                                  el * c)
    out = gated[token_slots[:, 0]]
    for r in range(1, top_k):
        out = out + gated[token_slots[:, r]]
    if par is not None:
        out = par.from_tp(out)

    return out.reshape(b, s, d).to(x.dtype), Routing(logits, probs,
                                                     expert_ids, keep)
