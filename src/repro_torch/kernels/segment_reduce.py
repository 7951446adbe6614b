"""Segment reduce over CSR row bounds: the CUDA kernel and its plain twin.

``out[i] = Σ_{e ∈ [bounds[i], bounds[i+1])} vals[e]`` for row-sorted
per-edge payloads (E,) or (E, D); the two reductions of every UMAP epoch
(``umap.epoch_delta``) run through here.

* :func:`segment_reduce_cuda` launches ``csrc/segment_reduce.cu`` (one
  warp per row, fp32 accumulation, deterministic; the source note says
  what bounds it).  It takes CUDA tensors only and raises on anything
  else.
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

from repro_torch.kernels import LAUNCHES, _build

_C_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                + [ctypes.c_void_p])
_FN = None          # the C entry point, set up once at first launch


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("segment_reduce").segment_reduce_f32
        fn.argtypes = _C_SIGNATURE
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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


def _launch(v, bounds, out, n, d) -> int:
    return _fn()(v.data_ptr(), bounds.data_ptr(), out.data_ptr(), n, d,
                 torch.cuda.current_stream().cuda_stream)


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
        if vals.device.index == torch.cuda.current_device():
            rc = _launch(v, bounds, out, n, d)
        else:
            with torch.cuda.device(vals.device):
                rc = _launch(v, bounds, out, n, d)
        if rc != 0:
            raise RuntimeError(f"segment_reduce kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["segment_reduce"] += 1
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
