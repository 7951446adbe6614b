"""Mamba2 / SSD (state-space duality) layer, chunked matmul form.  The port
of ``repro.models.ssm``.

The selective state-space recurrence

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t,      y_t = C_t h_t + D x_t

runs in chunks: within a chunk it unrolls into a masked (C·Bᵀ ∘ decay)
matmul; across chunks a small (H, P, N) state carries.  Decode is the
O(1)-per-token recurrent form.

The reference writes three of its contractions as 3-operand einsums,
whose association XLA's einsum path picks by shape.  Here each is two
explicit pairwise steps, in the association the path takes at jamba's
width: (C·Bᵀ ∘ decay) then the sum over s; (decay ∘ Δx) then the sum
over s against B; C against the prior state, then the decay.  Left to
``torch.einsum``'s own path, the first could form a (B, nc, H, Q, Q, P)
product.  All of it is f32, whatever the activation dtype.

On a mesh (``par`` set by ``launch.sharding.shard_model``) the training
forward is tensor-parallel over "model": ``w_z``, ``w_x``, ``conv_x``,
``conv_bias_x``, ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_scale``
hold this rank's SSD heads; ``w_b``, ``w_c``, ``w_dt`` and the B/C conv
are replicated and computed whole, then narrowed to the rank's heads;
``w_out`` is row-parallel and summed over "model", and the gated norm's
sum of squares over d_inner is summed over "model" too.  The decode step
(:func:`ssm_decode_step`) cuts its state the same way: the rank's heads
of ``ssm`` and ``conv_x``, ``conv_bc`` whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import _normal_, _param, rms_norm, silu


class Mamba2(nn.Module):
    """Per-component projections (z, x, B, C, dt), the depthwise causal conv,
    A/D/dt_bias per head (f32) and the gated norm's scale.  Heads may be
    TP-padded above ``real_heads`` (zeroed z/x lanes and dt columns)."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, heads: int,
                 real_heads: int, conv_width: int, dtype, device=None):
        super().__init__()
        self.real_heads = real_heads
        self.par = None
        d_in_pad = heads * (d_inner // real_heads)
        f32 = torch.float32
        shapes = {
            "w_z": ((d_model, d_in_pad), dtype),
            "w_x": ((d_model, d_in_pad), dtype),
            "w_b": ((d_model, n_state), dtype),
            "w_c": ((d_model, n_state), dtype),
            "w_dt": ((d_model, heads), dtype),
            "conv_x": ((conv_width, d_in_pad), dtype),
            "conv_b": ((conv_width, n_state), dtype),
            "conv_c": ((conv_width, n_state), dtype),
            "conv_bias_x": ((d_in_pad,), dtype),
            "conv_bias_b": ((n_state,), dtype),
            "conv_bias_c": ((n_state,), dtype),
            "a_log": ((heads,), f32),
            "d_skip": ((heads,), f32),
            "dt_bias": ((heads,), f32),
            "w_out": ((d_in_pad, d_model), dtype),
            "norm_scale": ((d_in_pad,), dtype),
        }
        for name, (shape, dt) in shapes.items():
            setattr(self, name, _param(shape, dt, device))

    @property
    def heads(self) -> int:
        """Padded SSD head count."""
        return self.a_log.shape[0]

    @property
    def n_state(self) -> int:
        return self.w_b.shape[1]

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        d_model, d_in_pad = self.w_z.shape
        d_inner = self.real_heads * (d_in_pad // self.heads)
        si = float(1.0 / math.sqrt(d_model))
        for w in (self.w_z, self.w_x, self.w_dt, self.w_b, self.w_c):
            _normal_(w, gen, si)
        self.w_z[:, d_inner:] = 0
        self.w_x[:, d_inner:] = 0
        self.w_dt[:, self.real_heads:] = 0
        for w in (self.conv_x, self.conv_b, self.conv_c):
            _normal_(w, gen, 0.1)
        for w in (self.conv_bias_x, self.conv_bias_b, self.conv_bias_c,
                  self.dt_bias):
            w.zero_()
        self.a_log.copy_(torch.log(torch.clip(
            1.0 + torch.arange(self.heads, dtype=torch.float32), 1.0, 16.0)))
        self.d_skip.fill_(1.0)
        _normal_(self.w_out, gen, float(1.0 / math.sqrt(d_inner)))
        self.norm_scale.fill_(1.0)


class SsmState(NamedTuple):
    """Decode-time recurrent state."""
    ssm: torch.Tensor         # (B, H, P, N) f32
    conv_x: torch.Tensor      # (B, W-1, d_in_pad) conv lookback
    conv_bc: torch.Tensor     # (B, W-1, 2*N)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., Q) per-step log decays -> (..., Q, Q) lower-tri cumulative sums:
    out[t, s] = sum_{r=s+1..t} log_a_r (the decay from step s to t)."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]              # (…, t, s)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    xh (B, S, H, P), dt (B, S, H) positive, b/c (B, S, N), a_log (H,); S a
    multiple of ``chunk``.  Returns (y (B, S, H, P), final_state
    (B, H, P, N)), all f32.
    """
    bsz, s, h, p = xh.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence of {s} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc = s // chunk
    xf = xh.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)
    a = -torch.exp(a_log.float())                           # (H,) negative
    log_decay = dtf * a                                     # (B, nc, Q, H)
    xdt = xf * dtf[..., None]                               # Δ·x

    # intra-chunk: y[t] += Σ_s≤t C_t·B_s exp(Σ_{s<r≤t}) x_s
    decay_mat = torch.exp(_segsum(log_decay.transpose(-1, -2)))
    cb = cf @ bf.transpose(-1, -2)                          # (B, nc, Q, Q)
    w = cb[:, :, None] * decay_mat                          # (B, nc, H, Q, Q)
    y_diag = (w @ xdt.transpose(2, 3)).transpose(2, 3)      # (B, nc, Q, H, P)

    # chunk-final states: S_g = Σ_s exp(Σ_{s<r≤Q}) B_s ⊗ (Δx)_s
    cum = torch.cumsum(log_decay, dim=2)                    # (B, nc, Q, H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    u = decay_to_end[..., None] * xdt                       # (B, nc, Q, H, P)
    states = torch.einsum("bgsn,bgshp->bghpn", bf, u)

    # inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B, nc, H)
    carry = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=xh.device) if init_state is None \
        else init_state.float()
    prior = []
    for g in range(nc):
        prior.append(carry)                                 # state BEFORE g
        carry = carry * chunk_decay[:, g, :, None, None] + states[:, g]
    prior = torch.stack(prior, dim=1)                       # (B, nc, H, P, N)

    # off-diagonal: y[t] += C_t exp(Σ_{0<r≤t}) S_prior
    y_off = torch.einsum("bgtn,bghpn->bgthp", cf, prior) \
        * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(bsz, s, h, p), carry


def _dw_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             lookback: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d + silu.  x (B, S, Ch), w (W, Ch)."""
    width = w.shape[0]
    if lookback is None:
        lookback = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                               dtype=x.dtype, device=x.device)
    xp = torch.cat([lookback, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    new_lb = xp[:, -(width - 1):, :] if width > 1 else lookback
    return silu(out + bias[None, None, :]), new_lb


def _gated_out(p: Mamba2, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor, dtype) -> torch.Tensor:
    """y + D·x, back to the activation dtype, the gated RMSNorm (mamba2's
    norm(y * silu(z))) and the out projection."""
    y = y + xh.float() * p.d_skip[:, None]
    y = y.reshape(*z.shape).to(dtype)
    par = p.par
    if par is None or par.tp is None:
        return rms_norm(y * silu(z), p.norm_scale) @ p.w_out
    v = y * silu(z)
    vf = v.float()
    # the mean of squares over the whole d_inner: this rank's share summed
    # over "model", on every rank, and every rank's gradient summed back
    ss = par.to_tp(par.from_tp(torch.sum(vf * vf, dim=-1, keepdim=True)))
    var = ss / (v.shape[-1] * par.tp_size)
    out = (vf * torch.rsqrt(var + 1e-5) * p.norm_scale.float()).to(dtype)
    return par.from_tp(out @ p.w_out)


def ssm_forward(p: Mamba2, x: torch.Tensor, *, chunk: int,
                state: Optional[SsmState] = None
                ) -> Tuple[torch.Tensor, SsmState]:
    """Full Mamba2 block (prefill).  x (B, S, D)."""
    n_state = p.n_state
    par = p.par
    xt = x if par is None else par.to_tp(x)
    z = xt @ p.w_z                                          # (B, S, d_in_pad)
    xr = xt @ p.w_x
    bc = torch.cat([x @ p.w_b, x @ p.w_c], dim=-1)
    dt_raw = x @ p.w_dt                                     # (B, S, H)
    xh, new_lb_x = _dw_conv(xr, p.conv_x, p.conv_bias_x,
                            None if state is None else state.conv_x)
    bc_out, new_lb_bc = _dw_conv(
        bc, torch.cat([p.conv_b, p.conv_c], dim=-1),
        torch.cat([p.conv_bias_b, p.conv_bias_c]),
        None if state is None else state.conv_bc)
    if par is not None and par.tp is not None:
        start, hl = par.tp_block(dt_raw.shape[-1])
        bc_out = par.to_tp(bc_out)
        dt_raw = par.to_tp(dt_raw)[..., start:start + hl]
    xh = xh.reshape(*xh.shape[:-1], p.heads, -1)
    dt = _softplus(dt_raw.float() + p.dt_bias)
    y, final = ssd_scan(xh, dt, p.a_log, bc_out[..., :n_state],
                        bc_out[..., n_state:], chunk,
                        None if state is None else state.ssm)
    return _gated_out(p, y, xh, z, x.dtype), SsmState(
        ssm=final, conv_x=new_lb_x, conv_bc=new_lb_bc)


def ssm_decode_step(p: Mamba2, x: torch.Tensor, state: SsmState
                    ) -> Tuple[torch.Tensor, SsmState]:
    """O(1) single-token recurrence.  x (B, 1, D).  On a mesh the state
    holds this rank's heads (``ssm``, ``conv_x``) and the B/C lookback
    whole, as :func:`ssm_forward` computes them."""
    n_state = p.n_state
    par = p.par
    xt = x if par is None else par.to_tp(x)
    z = xt @ p.w_z
    xr = xt @ p.w_x
    bc = torch.cat([x @ p.w_b, x @ p.w_c], dim=-1)
    dt_raw = x @ p.w_dt
    if par is not None and par.tp is not None:
        start, hl = par.tp_block(dt_raw.shape[-1])
        dt_raw = dt_raw[..., start:start + hl]
    width = p.conv_x.shape[0]

    def one_step_conv(xin, lb, w, bias):
        xp = torch.cat([lb, xin], dim=1)                    # (B, W, Ch)
        out = sum(xp[:, i:i + 1, :] * w[i][None, None, :]
                  for i in range(width))
        return silu(out + bias[None, None, :]), xp[:, 1:, :]

    xh, new_lb_x = one_step_conv(xr, state.conv_x, p.conv_x, p.conv_bias_x)
    bc_out, new_lb_bc = one_step_conv(
        bc, state.conv_bc, torch.cat([p.conv_b, p.conv_c], dim=-1),
        torch.cat([p.conv_bias_b, p.conv_bias_c]))
    bf = bc_out[:, 0, :n_state].float()                     # (B, N)
    cf = bc_out[:, 0, n_state:].float()
    xh = xh.reshape(xh.shape[0], p.heads, -1).float()       # (B, H, P)
    dt = _softplus(dt_raw[:, 0, :].float() + p.dt_bias)     # (B, H)
    decay = torch.exp(dt * -torch.exp(p.a_log.float()))     # (B, H)
    new_state = state.ssm * decay[:, :, None, None] + \
        (xh * dt[:, :, None])[..., None] * bf[:, None, None, :]
    y = (new_state @ cf[:, None, :, None])[..., 0]          # (B, H, P)
    return _gated_out(p, y[:, None], xh[:, None], z, x.dtype), SsmState(
        ssm=new_state, conv_x=new_lb_x, conv_bc=new_lb_bc)
