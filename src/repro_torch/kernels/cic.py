"""Cloud-in-cell splat (K2) and gather (K3): the CUDA kernels and their
plain twins.

The sparse tSNE backend moves every point through a G×G grid once per
iteration (``tsne.fft_repulsion``): splat the masses (1, y_x, y_y)
bilinearly onto the grid, FFT-convolve, gather the fields back.  A point
sits in cell ``i0`` (N, 2) int32 in [0, G−2] at fractional offset ``f``
(N, 2); its corner weights are (1−fx)(1−fy), (1−fx)fy, fx(1−fy), fx·fy.
Layouts are the reference's (``repro.kernels.cic``): ``vals`` (N, C) →
grid (C, G, G); ``fields`` (C, G, G) → (N, C).

* :func:`cic_splat_cuda` / :func:`cic_gather_cuda` launch
  ``csrc/cic.cu`` (one thread per point; the splat adds with float
  atomics, the gather is deterministic).  CUDA tensors only.
* :func:`cic_splat_torch` / :func:`cic_gather_torch` are the plain
  versions, ``cic_splat_xla`` / ``cic_gather_xla``'s arithmetic, in the
  dtype of ``vals`` / ``fields`` (float64 for the card's checks).
* :func:`cic_splat` / :func:`cic_gather` dispatch by device: a CUDA
  tensor launches the kernel or raises, a CPU tensor takes the twin.

The reference pads the point list to its tile (ops.py:96-143): padded
rows carry zero mass and splat nothing, and gathered padded rows are
sliced off.  The kernels mask the ragged tail themselves, so the port
pads nothing; a zero-mass row still splats nothing here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# (three tensors, n, c, g, out, stream): both entry points
_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_void_p] * 2
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _check_points(op: str, i0: torch.Tensor, f: torch.Tensor,
                  other: torch.Tensor) -> None:
    if not (i0.is_cuda and f.is_cuda and other.is_cuda):
        raise ValueError(f"{op}_cuda takes CUDA tensors; got i0 on "
                         f"{i0.device}, f on {f.device}, the third on "
                         f"{other.device}")
    if not i0.device == f.device == other.device:
        raise ValueError(f"{op}: tensors on different devices")
    if i0.dtype != torch.int32:
        raise ValueError(f"{op}: i0 must be int32, got {i0.dtype}")
    if f.dtype != torch.float32 or other.dtype != torch.float32:
        raise ValueError(f"{op}: f and the values must be float32")
    n = i0.shape[0]
    if i0.shape != (n, 2) or f.shape != (n, 2):
        raise ValueError(f"{op}: need i0 and f of shape (N, 2); got "
                         f"{tuple(i0.shape)} and {tuple(f.shape)}")
    if not (i0.is_contiguous() and f.is_contiguous()
            and other.is_contiguous()):
        raise ValueError(f"{op}: tensors must be contiguous")


def cic_splat_cuda(i0: torch.Tensor, f: torch.Tensor, vals: torch.Tensor,
                   grid_size: int) -> torch.Tensor:
    """(N, C) masses onto a (C, G, G) grid by the hand-written kernel."""
    _check_points("cic_splat", i0, f, vals)
    if vals.dim() != 2 or vals.shape[0] != i0.shape[0] or grid_size < 2:
        raise ValueError(f"cic_splat: need vals (N, C) beside i0 "
                         f"{tuple(i0.shape)} and G >= 2; got "
                         f"{tuple(vals.shape)}, G = {grid_size}")
    n, c = vals.shape
    out = torch.zeros((c, grid_size, grid_size), dtype=torch.float32,
                      device=vals.device)
    if n and c:
        fn = _build.entry("cic", "cic_splat_f32", _SIG)
        _build.launch("cic_splat", fn, vals.device, i0.data_ptr(),
                      f.data_ptr(), vals.data_ptr(), n, c, grid_size,
                      out.data_ptr())
    return out


def cic_gather_cuda(fields: torch.Tensor, i0: torch.Tensor, f: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear read of (C, G, G) fields at N points, (N, C), by the
    hand-written kernel."""
    _check_points("cic_gather", i0, f, fields)
    if fields.dim() != 3 or fields.shape[1] != fields.shape[2] \
            or fields.shape[1] < 2:
        raise ValueError(f"cic_gather: need fields (C, G, G) with G >= 2; "
                         f"got {tuple(fields.shape)}")
    c, g = fields.shape[0], fields.shape[1]
    n = i0.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=fields.device)
    if n and c:
        fn = _build.entry("cic", "cic_gather_f32", _SIG)
        _build.launch("cic_gather", fn, fields.device, fields.data_ptr(),
                      i0.data_ptr(), f.data_ptr(), n, c, g, out.data_ptr())
    return out


def _corner_weight(f: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    return ((f[:, 0] if dx else 1.0 - f[:, 0])
            * (f[:, 1] if dy else 1.0 - f[:, 1]))


def cic_splat_torch(i0: torch.Tensor, f: torch.Tensor, vals: torch.Tensor,
                    grid_size: int) -> torch.Tensor:
    """Plain splat: one index_add_ per corner on the flattened grid."""
    g = grid_size
    f = f.to(vals.dtype)
    ix, iy = i0[:, 0].to(torch.int64), i0[:, 1].to(torch.int64)
    out = torch.zeros((vals.shape[1], g * g), dtype=vals.dtype,
                      device=vals.device)
    for dx, dy in _CORNERS:
        w = _corner_weight(f, dx, dy)
        out.index_add_(1, (ix + dx) * g + iy + dy, w[None, :] * vals.T)
    return out.view(vals.shape[1], g, g)


def cic_gather_torch(fields: torch.Tensor, i0: torch.Tensor, f: torch.Tensor
                     ) -> torch.Tensor:
    """Plain gather: four corner reads, bilinearly weighted, summed in
    corner order from 0 (the kernel's order)."""
    f = f.to(fields.dtype)
    ix, iy = i0[:, 0].to(torch.int64), i0[:, 1].to(torch.int64)
    acc = torch.zeros((i0.shape[0], fields.shape[0]), dtype=fields.dtype,
                      device=fields.device)
    for dx, dy in _CORNERS:
        w = _corner_weight(f, dx, dy)
        acc = acc + w[:, None] * fields[:, ix + dx, iy + dy].T
    return acc


def cic_splat(i0: torch.Tensor, f: torch.Tensor, vals: torch.Tensor,
              grid_size: int) -> torch.Tensor:
    """(N, C) channel masses → (C, G, G) grid: the kernel for CUDA
    tensors (launches or raises), the plain version for CPU tensors."""
    if vals.is_cuda:
        return cic_splat_cuda(i0, f, vals, grid_size)
    return cic_splat_torch(i0, f, vals, grid_size)


def cic_gather(fields: torch.Tensor, i0: torch.Tensor, f: torch.Tensor
               ) -> torch.Tensor:
    """Bilinear read of (C, G, G) fields at N points → (N, C): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if fields.is_cuda:
        return cic_gather_cuda(fields, i0, f)
    return cic_gather_torch(fields, i0, f)
