"""Segment reduce over CSR row bounds: the CUDA kernel and its plain twin.

``out[i] = Σ_{e ∈ [bounds[i], bounds[i+1])} vals[e]`` for row-sorted
per-edge payloads (E,) or (E, D); the two reductions of every UMAP epoch
(``umap.epoch_delta``) run through here.

* :func:`segment_reduce_cuda` launches ``csrc/segment_reduce.cu``: a
  group of L lanes per row (L from :func:`group_lanes`, the shapes
  alone), each edge's payload row read by one vector load, fp32
  accumulation, deterministic; the source note says what bounds it.  It
  takes CUDA tensors only and raises on anything else.
* :func:`segment_reduce_torch` is the plain version: the reference's
  cumsum difference (``repro.core.coo.segment_reduce``, the ``xla``
  tier).  ``coo.segment_reduce`` reaches it for CPU tensors only.

The two agree bit for bit on integer-valued fp32 payloads below 2**24 and
to fp32 rounding otherwise: a direct per-row sum and a cumsum difference
associate the additions differently.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_C_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                + [ctypes.c_void_p])


def group_lanes(n_rows: int, n_edges: int) -> int:
    """The kernel's lanes per row: the smallest power of two >= E / 2N,
    at most a warp (32), so a mean row takes about two strides of its
    group.  From the shapes alone: choosing it waits on nothing."""
    want = -(-n_edges // (2 * max(n_rows, 1)))
    return min(32, 1 << max(want - 1, 0).bit_length())


def _check(vals: torch.Tensor, bounds: torch.Tensor) -> None:
    if not (vals.is_cuda and bounds.is_cuda):
        raise ValueError(f"segment_reduce_cuda takes CUDA tensors; got vals "
                         f"on {vals.device}, bounds on {bounds.device}")
    if vals.device != bounds.device:
        raise ValueError(f"vals on {vals.device} but bounds on "
                         f"{bounds.device}")
    if vals.dtype != torch.float32:
        raise ValueError(f"vals must be float32, got {vals.dtype}")
    if bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be int32, got {bounds.dtype}")
    if vals.dim() not in (1, 2) or bounds.dim() != 1 or bounds.shape[0] < 1:
        raise ValueError(f"need vals (E,) or (E, D) and bounds (N+1,); got "
                         f"{tuple(vals.shape)} and {tuple(bounds.shape)}")
    if not (vals.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("vals and bounds must be contiguous")
    if vals.dim() == 2 and vals.shape[1] == 2 and vals.data_ptr() % 8:
        raise ValueError("vals (E, 2) must be 8-byte aligned: the kernel "
                         "reads each edge as one float2")


def segment_reduce_cuda(vals: torch.Tensor, bounds: torch.Tensor
                        ) -> torch.Tensor:
    """Row sums by the hand-written kernel.  ``bounds`` must ascend from 0
    to at most E (``coo.row_bounds`` output); that is the caller's
    contract, not checked here, as checking would wait on the card."""
    _check(vals, bounds)
    v = vals[:, None] if vals.dim() == 1 else vals
    n, d = bounds.shape[0] - 1, v.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=vals.device)
    if n and d:
        fn = _build.entry("segment_reduce", "segment_reduce_f32",
                          _C_SIGNATURE)
        _build.launch("segment_reduce", fn, vals.device, v.data_ptr(),
                      bounds.data_ptr(), out.data_ptr(), n, d,
                      group_lanes(n, v.shape[0]))
    return out[:, 0] if vals.dim() == 1 else out


def segment_reduce_torch(vals: torch.Tensor, bounds: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version: the cumsum difference at the row bounds.  Each
    payload column is scanned as its own 1-D tensor: on the card PyTorch
    scans the leading dim of an (E, 2) tensor with one thread per column
    (37 ms at E = 7e5 on an H100, chip_smoke) and the rows of a (2, E)
    tensor with one block per row (0.9 ms); a 1-D scan is one device-wide
    pass."""
    v = vals.reshape(vals.shape[0], math.prod(vals.shape[1:])).T  # (D, E)
    cs = v.new_zeros((v.shape[0], v.shape[1] + 1))
    for c in range(v.shape[0]):
        torch.cumsum(v[c], dim=0, out=cs[c, 1:])
    b = bounds.to(torch.int64)
    out = cs[:, b[1:]] - cs[:, b[:-1]]                       # (D, N)
    return out.T.reshape((b.shape[0] - 1,) + tuple(vals.shape[1:]))
