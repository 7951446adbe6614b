"""Adafactor (Shazeer & Stern 2018): factored second moments (the port of
``repro.optim.adafactor``).

For a matrix (or the last two axes of a higher-rank leaf) the second
moment is kept as row and column statistics.  The reference stacks each
layer's weights over superblocks into one leaf, and two of its choices
read the whole stack: whether a leaf is factored (``_should_factor`` of
the stacked shape) and the RMS clip of the update (one mean over the
stack).  The port keeps a weight a layer, so ``stacks`` names the
layers' weights that the reference stacks together, in superblock order
(``models.model.param_stacks``); every other parameter stands alone."""
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
                   stacks: Stacks = ()) -> AdafactorState:
    vr, vc, factored = {}, {}, {}
    for names, stacked in _groups(params, stacks):
        shape = tuple(params[names[0]].shape)
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


@torch.no_grad()
def adafactor_update(grads: Tensors, state: AdafactorState, params: Tensors,
                     cfg: AdafactorConfig, lr: Optional[float] = None,
                     stacks: Stacks = ()) -> Tuple[Tensors, AdafactorState]:
    """Returns (params, new state); parameters and statistics are updated
    in place."""
    lr = cfg.lr if lr is None else float(lr)
    step = state.step + 1
    beta2 = float(1.0 - torch.tensor(float(step)) ** (-cfg.decay))
    for names, _ in _groups(params, stacks):
        us = []
        for n in names:
            gf = grads[n].float()
            g2 = gf * gf + cfg.eps
            vr, vc = state.vr[n], state.vc[n]
            if state.factored[n]:
                vr.copy_(beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1))
                vc.copy_(beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2))
                row_mean = torch.mean(vr, dim=-1, keepdim=True)
                us.append(gf / (torch.sqrt(vr / row_mean)[..., None]
                                * torch.sqrt(vc)[..., None, :]))
            else:
                vr.copy_(beta2 * vr + (1 - beta2) * g2)
                us.append(gf / torch.sqrt(vr))
        # update clipping (RMS), over the reference's whole leaf
        count = sum(u.numel() for u in us)
        rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / count)
        div = torch.clamp(rms / cfg.clip_threshold, min=1.0)
        for n, u in zip(names, us):
            p = params[n]
            pf = p.float()
            p.copy_(pf - lr * (u / div) - lr * cfg.weight_decay * pf)
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc,
                                  factored=state.factored)
