"""The fused exact tSNE gradient in two passes — K5a ``tsne_z`` and K5b
``tsne_forces`` — as CUDA kernels, their plain twins, and the padding
wrapper :func:`tsne_step_fused` (the reference's ``ops.tsne_step_fused``).

    pass 1:  Z   = Σ_{i≠j valid} 1/(1+|y_i−y_j|²)
    pass 2:  F_i = 4 Σ_j (exag·P_ij − num_ij/Z)·num_ij·(y_i−y_j)
             kl_parts = [Σ pe·log pe, Σ pe·log num] over pairs with pe > 0

with P_ij = ½(w_i·pc(j|i) + w_j·pc(i|j)) rebuilt from stats (N, 4) =
[beta, shift, zp, w] and pe = exag·P.  Rows at or past ``n_valid`` are
padding (w = 0, zp = 1) and take part in no pair.  No N×N matrix is
stored by the kernels.

* :func:`tsne_z_cuda` / :func:`tsne_forces_cuda` launch
  ``csrc/tsne_forces.cu`` (row tiles × column splits, fp64 partials summed
  in a fixed order: deterministic).  CUDA tensors only.  Z comes back as
  a float32 tensor on the card and goes into pass 2 without a host sync;
  the KL partials come back in float64.
* :func:`tsne_z_torch` / :func:`tsne_forces_torch` are the plain
  versions: ``tsne_step_xla``'s arithmetic (Gram-identity distances, the
  same masking and KL partials) in the inputs' dtype, streamed in row
  blocks so that no (N, N) temporary outgrows ``rows`` × N.  The
  ``tiled`` backend of ``core.tsne`` is these twins at its own block.
* :func:`tsne_z` / :func:`tsne_forces` / :func:`tsne_step` dispatch by
  device: a CUDA tensor launches the kernel or raises, a CPU tensor takes
  the twin.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

_Z_SIG = [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3
_F_SIG = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
           ctypes.c_longlong] + [ctypes.c_void_p] * 5)
_X_WIDTHS = (8, 16, 32)          # the kernel's compiled x widths
_Y_WIDTHS = (2, 4)               # and embedding widths
_BLOCKS_PER_SM = 8               # column splits aim at this many blocks
_SMS: Dict[int, int] = {}
_TWIN_ROWS = 2048                # the twins' default row block


def _pad_cols(t: torch.Tensor, widths) -> torch.Tensor:
    """Zero columns up to the next compiled width: a zero column changes
    no distance and gets no force."""
    w = next((w for w in widths if w >= t.shape[1]), None)
    if w is None:
        raise ValueError(f"the tsne kernels take at most {widths[-1]} "
                         f"columns; got {t.shape[1]}")
    if w == t.shape[1]:
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, w - t.shape[1]))


def _splits(n: int, device: torch.device) -> Tuple[int, int]:
    """(row tiles, column splits): enough blocks to give every SM
    ``_BLOCKS_PER_SM``, never more splits than row tiles' worth of
    columns."""
    rows = _build.entry("tsne_forces", "tsne_block_rows", [])()
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    tiles = -(-n // rows)
    want = -(-_BLOCKS_PER_SM * _SMS[idx] // tiles)
    return tiles, max(1, min(want, tiles))


def _check(op: str, **tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    if not all(t.is_cuda for t in tensors.values()) or len(devs) != 1:
        raise ValueError(f"{op}_cuda takes CUDA tensors on one device; got "
                         + ", ".join(f"{k} on {t.device}"
                                     for k, t in tensors.items()))
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{op}: {k} must be float32, got {t.dtype}")
    return devs.pop()


def tsne_z_cuda(y: torch.Tensor, n_valid: Optional[int] = None
                ) -> torch.Tensor:
    """Z by the hand-written kernel: a 0-dim float32 tensor on the card."""
    dev = _check("tsne_z", y=y)
    n = y.shape[0]
    n_valid = n if n_valid is None else n_valid
    yp = _pad_cols(y, _Y_WIDTHS)
    z = torch.zeros((1,), dtype=torch.float32, device=dev)
    if n:
        tiles, splits = _splits(n, dev)
        zpart = torch.empty((tiles * splits,), dtype=torch.float64,
                            device=dev)
        fn = _build.entry("tsne_forces", "tsne_z_f32", _Z_SIG)
        _build.launch("tsne_z", fn, dev, yp.data_ptr(), n, yp.shape[1],
                      n_valid, splits, zpart.data_ptr(), z.data_ptr())
    return z[0]


def tsne_forces_cuda(x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                     z: torch.Tensor, exaggeration: float,
                     n_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(forces (N, dims) float32, kl_parts (2,) float64) by the
    hand-written kernel; ``z`` is pass 1's tensor, read on the card."""
    dev = _check("tsne_forces", x=x, y=y, stats=stats, z=z)
    n, dims = y.shape
    if x.shape[0] != n or stats.shape != (n, 4) or z.numel() != 1:
        raise ValueError(f"tsne_forces: need x (N, Dh), y (N, dims), stats "
                         f"(N, 4), z scalar; got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}, {tuple(stats.shape)}, "
                         f"{tuple(z.shape)}")
    n_valid = n if n_valid is None else n_valid
    xp = _pad_cols(x, _X_WIDTHS)
    yp = _pad_cols(y, _Y_WIDTHS)
    st = stats.contiguous()
    if xp.data_ptr() % 16 or st.data_ptr() % 16:
        raise ValueError("tsne_forces: x and stats must be 16-byte aligned")
    forces = torch.zeros((n, yp.shape[1]), dtype=torch.float32, device=dev)
    kl = torch.zeros((2,), dtype=torch.float64, device=dev)
    if n:
        tiles, splits = _splits(n, dev)
        fpart = torch.empty((splits, n, yp.shape[1]), dtype=torch.float64,
                            device=dev)
        klpart = torch.empty((tiles * splits, 2), dtype=torch.float64,
                             device=dev)
        fn = _build.entry("tsne_forces", "tsne_forces_f32", _F_SIG)
        _build.launch("tsne_forces", fn, dev, xp.data_ptr(), xp.shape[1],
                      yp.data_ptr(), yp.shape[1], st.data_ptr(), n, n_valid,
                      z.data_ptr(), float(exaggeration), splits,
                      fpart.data_ptr(), klpart.data_ptr(), forces.data_ptr(),
                      kl.data_ptr())
    return forces[:, :dims], kl


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference kernel's Gram-identity squared distances."""
    a2 = (a * a).sum(1)
    b2 = (b * b).sum(1)
    return (a2[:, None] - 2.0 * (a @ b.T) + b2[None, :]).clamp_(min=0.0)


def _pair_mask(lo: int, hi: int, n: int, n_valid: int, device
               ) -> torch.Tensor:
    gi = torch.arange(lo, hi, device=device)[:, None]
    gj = torch.arange(n, device=device)[None, :]
    return (gi != gj) & (gi < n_valid) & (gj < n_valid)


def tsne_z_torch(y: torch.Tensor, n_valid: Optional[int] = None,
                 rows: int = _TWIN_ROWS) -> torch.Tensor:
    """Plain pass 1 in y's dtype: a 0-dim tensor."""
    n = y.shape[0]
    n_valid = n if n_valid is None else n_valid
    z = y.new_zeros(())
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        num = 1.0 / (1.0 + _sq_dists(y[lo:hi], y))
        z = z + torch.where(_pair_mask(lo, hi, n, n_valid, y.device),
                            num, 0.0).sum()
    return z


def tsne_forces_torch(x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                      z: torch.Tensor, exaggeration: float,
                      n_valid: Optional[int] = None, rows: int = _TWIN_ROWS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain pass 2 in the inputs' dtype: (forces (N, dims), kl_parts
    (2,))."""
    n = x.shape[0]
    n_valid = n if n_valid is None else n_valid
    dt = y.dtype
    x, stats = x.to(dt), stats.to(dt)
    beta, shift, zp, w = stats.unbind(1)
    forces = torch.empty_like(y)
    kl = y.new_zeros((2,))
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        mask = _pair_mask(lo, hi, n, n_valid, y.device)
        d2x = _sq_dists(x[lo:hi], x)
        pc_ij = torch.exp(-beta[lo:hi, None] * d2x - shift[lo:hi, None]) \
            / zp[lo:hi, None]
        pc_ji = torch.exp(-beta[None, :] * d2x - shift[None, :]) \
            / zp[None, :]
        p = torch.where(mask, 0.5 * (w[lo:hi, None] * pc_ij
                                     + w[None, :] * pc_ji), 0.0)
        num = torch.where(mask, 1.0 / (1.0 + _sq_dists(y[lo:hi], y)), 0.0)
        pe = exaggeration * p
        pq = (pe - num / z) * num
        forces[lo:hi] = 4.0 * (pq.sum(1, keepdim=True) * y[lo:hi] - pq @ y)
        live = pe > 0
        kl = kl + torch.stack([
            torch.where(live, pe * torch.log(pe.clamp(min=1e-37)), 0.0).sum(),
            torch.where(live, pe * torch.log(num.clamp(min=1e-37)),
                        0.0).sum()])
    return forces, kl


def tsne_z(y: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """Pass 1: the kernel for a CUDA tensor, the twin for a CPU one."""
    if y.is_cuda:
        return tsne_z_cuda(y, n_valid)
    return tsne_z_torch(y, n_valid)


def tsne_forces(x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
                z: torch.Tensor, exaggeration: float,
                n_valid: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: the kernel for CUDA tensors, the twin for CPU ones."""
    if y.is_cuda:
        return tsne_forces_cuda(x, y, stats, z, exaggeration, n_valid)
    return tsne_forces_torch(x, y, stats, z, exaggeration, n_valid)


def tsne_step(x: torch.Tensor, y: torch.Tensor, stats: torch.Tensor,
              exaggeration: float, n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both passes on (padded) arrays: (forces, kl_parts, z), the
    reference's registered ``tsne_step`` op."""
    z = tsne_z(y, n_valid)
    forces, kl_parts = tsne_forces(x, y, stats, z, exaggeration, n_valid)
    return forces, kl_parts, z


def pad_rows(t: torch.Tensor, block: int, value: float = 0.0
             ) -> torch.Tensor:
    pad = (-t.shape[0]) % block
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), value)])


def step_stats(beta: torch.Tensor, zp: torch.Tensor,
               shift: Optional[torch.Tensor], weights: Optional[torch.Tensor],
               block: int) -> torch.Tensor:
    """The (N_pad, 4) [beta, shift, zp, w] stats of ``tsne_step_fused``:
    shift None = 0, weights None = uniform 1/N, weights normalized;
    padded rows carry zp = 1 (no 0-division) and w = 0 (out of P)."""
    n = beta.shape[0]
    m = torch.zeros_like(beta) if shift is None else shift
    w = torch.full_like(beta, 1.0 / n) if weights is None \
        else weights / weights.sum()
    stats = torch.stack([beta, m, zp, w], 1).to(torch.float32)
    spad = pad_rows(stats, block)
    spad[n:, 2] = 1.0
    return spad


def tsne_step_fused(x: torch.Tensor, y: torch.Tensor, beta: torch.Tensor,
                    zp: torch.Tensor, *, shift: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None,
                    exaggeration: float = 1.0, block: int = 256,
                    return_kl: bool = False):
    """One fused tSNE gradient (pass 1 + pass 2) on rows padded to a
    multiple of ``block``; returns forces (N, dims) and, with
    ``return_kl``, the KL of exag·P against the current Q."""
    n = x.shape[0]
    stats = step_stats(beta, zp, shift, weights, block)
    f, kl_parts, z = tsne_step(pad_rows(x.to(torch.float32), block),
                               pad_rows(y.to(torch.float32), block), stats,
                               exaggeration, n_valid=n)
    if not return_kl:
        return f[:n]
    return f[:n], step_kl(kl_parts, z, exaggeration)


def step_kl(kl_parts: torch.Tensor, z: torch.Tensor, exaggeration: float
            ) -> torch.Tensor:
    """KL of exag·P against Q from the partials: Σ pe log pe − Σ pe log
    num + exag·log Z, as float32."""
    kl = kl_parts[0] - kl_parts[1] + exaggeration * torch.log(
        z.to(kl_parts.dtype))
    return kl.to(torch.float32)
