"""Adafactor (Shazeer & Stern 2018): factored second moments (the port of
``repro.optim.adafactor``).

For a matrix (or the last two axes of a higher-rank leaf) the second
moment is kept as row and column statistics.  The reference stacks each
layer's weights over superblocks into one leaf, and two of its choices
read the whole stack: whether a leaf is factored (``_should_factor`` of
the stacked shape) and the RMS clip of the update (one mean over the
stack).  The port keeps a weight a layer, so ``stacks`` names the
layers' weights that the reference stacks together, in superblock order
(``models.model.param_stacks``); every other parameter stands alone.

On a mesh (``mesh`` and each leaf's layout ``specs``, see
``launch.sharding``) a rank updates its blocks of the parameters and
keeps the statistics whole (replicated, as the reference's
``opt_pspecs``): the factored row and column sums of a block are summed
over the axes that split the reduced dimension and gathered along the
others before the division, an unfactored leaf's squares are gathered
whole, and the update's RMS sums its squares over the axes that split
each leaf."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]
Stacks = Sequence[Sequence[str]]


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8          # t^-decay second-moment decay schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_size_to_factor: int = 128
    weight_decay: float = 0.0


class AdafactorState(NamedTuple):
    step: int
    vr: Dict[str, torch.Tensor]   # row stats (or full v if not factored)
    vc: Dict[str, torch.Tensor]   # col stats (or a (1,) zero)
    factored: Dict[str, bool]


def _should_factor(shape, min_size) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def _groups(params: Tensors, stacks: Stacks):
    """[(names, stacked)]: each stack of ``stacks``, then every other
    parameter alone."""
    stacked = [tuple(s) for s in stacks]
    seen = {n for s in stacked for n in s}
    return [(s, True) for s in stacked] + [((n,), False) for n in params
                                           if n not in seen]


def adafactor_init(params: Tensors, cfg: AdafactorConfig = AdafactorConfig(),
                   stacks: Stacks = (), shapes=None) -> AdafactorState:
    """Zero statistics; ``shapes`` (default: the parameters') are the full
    leaves' shapes where ``params`` holds a rank's blocks."""
    vr, vc, factored = {}, {}, {}
    for names, stacked in _groups(params, stacks):
        shape = tuple(params[names[0]].shape if shapes is None
                      else shapes[names[0]])
        f = _should_factor((len(names),) + shape if stacked else shape,
                           cfg.min_dim_size_to_factor)
        for n in names:
            dev = params[n].device
            factored[n] = f
            vr[n] = torch.zeros(shape[:-1] if f else shape,
                                dtype=torch.float32, device=dev)
            vc[n] = torch.zeros(shape[:-2] + shape[-1:] if f else (1,),
                                dtype=torch.float32, device=dev)
    return AdafactorState(step=0, vr=vr, vc=vc, factored=factored)


def _row_col_means(g2: torch.Tensor, spec, mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full leaf's means of ``g2`` over its last and its second-last
    dimension, from this rank's block under ``spec``."""
    from repro_torch.core import mesh as mesh_mod
    nd = g2.ndim
    out = []
    for red in (nd - 1, nd - 2):
        s = torch.sum(g2, dim=red)
        if spec[red]:
            s = mesh_mod.all_reduce(s, mesh, spec[red])
        kept = [d for d in range(nd) if d != red]
        for i, d in enumerate(kept):
            if spec[d]:
                s = mesh_mod.all_gather_dim(s, mesh, spec[d], i)
        n = g2.shape[red] * (mesh_mod.axis_size(mesh, spec[red])
                             if spec[red] else 1)
        out.append(s / n)
    return out[0], out[1]


@torch.no_grad()
def adafactor_update(grads: Tensors, state: AdafactorState, params: Tensors,
                     cfg: AdafactorConfig, lr: Optional[float] = None,
                     stacks: Stacks = (), mesh=None, specs=None
                     ) -> Tuple[Tensors, AdafactorState]:
    """Returns (params, new state); parameters and statistics are updated
    in place.  On a ``mesh`` the parameters and gradients are this rank's
    blocks under ``specs``; the statistics are whole."""
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.launch.sharding import gather_full, local_shard, spec_axes
    lr = cfg.lr if lr is None else float(lr)
    step = state.step + 1
    beta2 = float(1.0 - torch.tensor(float(step)) ** (-cfg.decay))
    for names, _ in _groups(params, stacks):
        us = []
        for n in names:
            gf = grads[n].float()
            g2 = gf * gf + cfg.eps
            vr, vc = state.vr[n], state.vc[n]
            spec = None if mesh is None else specs[n]
            if state.factored[n]:
                if spec is None:
                    rm, cm = torch.mean(g2, dim=-1), torch.mean(g2, dim=-2)
                else:
                    rm, cm = _row_col_means(g2, spec, mesh)
                vr.copy_(beta2 * vr + (1 - beta2) * rm)
                vc.copy_(beta2 * vc + (1 - beta2) * cm)
                row_mean = torch.mean(vr, dim=-1, keepdim=True)
                r, c, rmean = vr, vc, row_mean
                if spec is not None:
                    r = local_shard(vr, spec[:-1], mesh)
                    rmean = local_shard(row_mean, spec[:-2] + (None,), mesh)
                    c = local_shard(vc, spec[:-2] + spec[-1:], mesh)
                us.append(gf / (torch.sqrt(r / rmean)[..., None]
                                * torch.sqrt(c)[..., None, :]))
            else:
                full = g2 if spec is None else gather_full(g2, spec, mesh)
                vr.copy_(beta2 * vr + (1 - beta2) * full)
                v = vr if spec is None else local_shard(vr, spec, mesh)
                us.append(gf / torch.sqrt(v))
        # update clipping (RMS), over the reference's whole leaf
        if mesh is None:
            count = sum(u.numel() for u in us)
            rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / count)
        else:
            axes = spec_axes(specs[names[0]])
            count = sum(u.numel() for u in us) * (
                mesh_mod.axis_size(mesh, axes) if axes else 1)
            ss = sum(torch.sum(u * u) for u in us)
            if axes:
                ss = mesh_mod.all_reduce(ss, mesh, axes)
            rms = torch.sqrt(ss / count)
        div = torch.clamp(rms / cfg.clip_threshold, min=1.0)
        for n, u in zip(names, us):
            p = params[n]
            pf = p.float()
            p.copy_(pf - lr * (u / div) - lr * cfg.weight_decay * pf)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc,
                                  factored=state.factored)
