"""AdamW with decoupled weight decay and global-norm clipping (the port of
``repro.optim.adamw``).

Parameters, gradients and the moments are dicts keyed by parameter name.
The moments are float32 whatever the parameter's dtype; the update runs
in float32 and writes the parameter back in its own dtype.  It updates
the parameters and moments in place (the reference's jitted train step
donates its state).

On a mesh (``mesh`` and each leaf's layout ``specs``, see
``launch.sharding``) every rank updates its blocks; the moments mirror
the parameters' layout, and the global norm adds each leaf's squares
once: a leaf's local sum is summed over the axes that split it, never
over those it is replicated on."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adamw_init(params: Tensors) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return AdamWState(step=0, m=zeros(), v=zeros())


def global_norm(tree: Tensors, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of Σ x², in float32; on a mesh over the
    full leaves, whose blocks ``tree`` holds under ``specs``."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree.values()))
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.launch.sharding import spec_axes
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for n, x in tree.items():
        axes = spec_axes(specs[n])
        ss = torch.sum(torch.square(x.float()))
        groups[axes] = ss if axes not in groups else groups[axes] + ss
    return torch.sqrt(sum(mesh_mod.all_reduce(v, mesh, axes) if axes else v
                          for axes, v in groups.items()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), in each leaf's dtype; the
    pre-clip norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def _pow_f32(base: float, exp: float) -> float:
    """``base ** exp`` as a float32 power of float32 operands."""
    return float(torch.pow(torch.tensor(base, dtype=torch.float32),
                           torch.tensor(exp, dtype=torch.float32)))


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors,
                 cfg: AdamWConfig, lr: Optional[float] = None, mesh=None,
                 specs=None) -> Tuple[Tensors, AdamWState, torch.Tensor]:
    """Returns (params, new state, pre-clip grad norm); ``params`` and the
    state's moments are updated in place.  On a ``mesh`` the leaves are
    this rank's blocks under ``specs``."""
    lr = cfg.lr if lr is None else float(lr)
    gnorm = global_norm(grads, mesh, specs)
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm else None
    step = state.step + 1
    b1c = float(1.0 - torch.tensor(_pow_f32(cfg.b1, step)))
    b2c = float(1.0 - torch.tensor(_pow_f32(cfg.b2, step)))
    for name, p in params.items():
        g = grads[name]
        gf = (g if scale is None else g * scale.to(g.dtype)).float()
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
