"""Fused quantize → pack → hash of a point block (K6): the CUDA kernel
and its plain twin.

For (N, D) float32 points, a fitted grid and R multiply-shift hashes,
the result is the pair ``hashing.hashes`` gives for the points' cell
keys: buckets (R, N) in [0, 2**log2_cols) and signs (R, N) in {−1, +1},
both int64 (the port's dtype for uint32 values): the reference's
``repro.kernels.hash_points`` behind ``ops.hash_points``.

* :func:`hash_points_cuda` launches ``csrc/sketch.cu`` (one thread per
  point, native 64-bit keys; the source note says what bounds it).  CUDA
  tensors only, float32 points.
* :func:`hash_points_torch` is the plain version: ``points_to_keys``
  then ``hashing.hashes`` (``repro.kernels.ref.hash_points``).
* :func:`hash_points` dispatches by device: a CUDA tensor launches the
  kernel or raises, a CPU tensor takes the twin.

The two agree bit for bit: the kernel rounds (p − lo) and its product
with 1/cell one by one, as the twin's two tensor ops do.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import hashing, quantize
from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.quantize import GridSpec
from repro_torch.kernels import _build

# (points, lo, inv, six param limbs, buckets, signs, n, d, rows, bins,
#  bits, log2_cols, stream)
_SIG = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
# the kernel stages R (a1, a2, b) triples of 24 bytes in shared memory,
# which a block may hold up to 48 KB of without the opt-in
MAX_ROWS = 2048


def check_params(op: str, params: MulShiftParams, device: torch.device
                 ) -> None:
    """The kernels read the six (R,) limb tensors through one pointer
    each: they must be on ``device``, int64, contiguous and of one
    length R in [1, MAX_ROWS]."""
    rows = params.rows
    for p in params:
        if p.device != device:
            raise ValueError(f"{op}: hash params must be on {device}")
        if p.dtype != torch.int64 or not p.is_contiguous() or \
                p.shape != (rows,):
            raise ValueError(f"{op}: hash params must be six contiguous "
                             f"(R,) int64 tensors")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{op}: rows must be in [1, {MAX_ROWS}], got "
                         f"{rows}")


def check_log2_cols(op: str, log2_cols: int) -> None:
    if not 1 <= log2_cols <= 32:
        raise ValueError(f"{op}: log2_cols must be in [1, 32], got "
                         f"{log2_cols}")


def hash_points_cuda(params: MulShiftParams, grid: GridSpec,
                     points: torch.Tensor, log2_cols: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buckets, signs), each (R, N) int64, by the hand-written kernel."""
    if not points.is_cuda:
        raise ValueError(f"hash_points_cuda takes CUDA tensors; got points "
                         f"on {points.device}")
    check_params("hash_points", params, points.device)
    check_log2_cols("hash_points", log2_cols)
    if points.dtype != torch.float32:
        raise ValueError(f"hash_points: points must be float32, got "
                         f"{points.dtype}")
    if points.dim() != 2 or points.shape[1] != grid.dims:
        raise ValueError(f"hash_points: need points (N, {grid.dims}); got "
                         f"{tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("hash_points: points must be contiguous")
    n, r = points.shape[0], params.rows
    buckets = torch.empty((r, n), dtype=torch.int64, device=points.device)
    signs = torch.empty((r, n), dtype=torch.int64, device=points.device)
    if n:
        lo, inv = quantize.grid_tensors(grid, points.device)
        fn = _build.entry("sketch", "hash_points_f32", _SIG)
        _build.launch("hash_points", fn, points.device, points.data_ptr(),
                      lo.data_ptr(), inv.data_ptr(),
                      *(p.data_ptr() for p in params), buckets.data_ptr(),
                      signs.data_ptr(), n, grid.dims, r, grid.bins,
                      grid.bits_per_dim, log2_cols)
    return buckets, signs


def hash_points_torch(params: MulShiftParams, grid: GridSpec,
                      points: torch.Tensor, log2_cols: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: cell keys, then the R bucket and sign hashes."""
    key_hi, key_lo = quantize.points_to_keys(grid, points)
    return hashing.hashes(params, key_hi, key_lo, log2_cols)


def hash_points(params: MulShiftParams, grid: GridSpec, points: torch.Tensor,
                log2_cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, N) buckets and signs of the points' cells: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if points.is_cuda:
        return hash_points_cuda(params, grid, points, log2_cols)
    return hash_points_torch(params, grid, points, log2_cols)
