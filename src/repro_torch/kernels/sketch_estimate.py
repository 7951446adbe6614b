"""Signed per-row gather from a Count Sketch table (K8): the CUDA kernel
and its plain twin.

For an (R, C) float32 table and (R, Q) int64 buckets and signs, the
result is (R, Q) float32 ``sign·table[r, bucket]``: ``sketch.estimate``
before its median over rows, and the reference's
``repro.kernels.sketch_estimate`` behind ``ops.sketch_estimate_mxu``.

* :func:`sketch_estimate_cuda` launches ``csrc/sketch.cu`` (one thread
  per (r, q); the source note says what bounds it).  CUDA tensors only.
  Buckets must lie in [0, C) (``hashing.hashes`` output at the table's
  log2 columns); that is the caller's contract, not checked here, as
  checking would wait on the card.
* :func:`sketch_estimate_torch` is the plain version, ``torch.gather``
  times the signs (``repro.kernels.ref.sketch_estimate``).
* :func:`sketch_estimate` dispatches by device: a CUDA tensor launches
  the kernel or raises, a CPU tensor takes the twin.

The two agree bit for bit (a product with ±1 is exact).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# (table, buckets, signs, out, rows, cols, q, stream)
_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def sketch_estimate_cuda(table: torch.Tensor, buckets: torch.Tensor,
                         signs: torch.Tensor) -> torch.Tensor:
    """(R, Q) signed table values by the hand-written kernel."""
    ts = (table, buckets, signs)
    if not all(t.is_cuda for t in ts):
        raise ValueError("sketch_estimate_cuda takes CUDA tensors; got "
                         + ", ".join(str(t.device) for t in ts))
    if len({t.device for t in ts}) != 1:
        raise ValueError("sketch_estimate: tensors on different devices")
    if table.dtype != torch.float32:
        raise ValueError(f"sketch_estimate: table must be float32, got "
                         f"{table.dtype}")
    if buckets.dtype != torch.int64 or signs.dtype != torch.int64:
        raise ValueError(f"sketch_estimate: buckets and signs must be int64, "
                         f"got {buckets.dtype} and {signs.dtype}")
    if table.dim() != 2 or buckets.dim() != 2 or \
            buckets.shape[0] != table.shape[0] or signs.shape != buckets.shape:
        raise ValueError(f"sketch_estimate: need table (R, C) and buckets and "
                         f"signs (R, Q); got {tuple(table.shape)}, "
                         f"{tuple(buckets.shape)}, {tuple(signs.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sketch_estimate: tensors must be contiguous")
    r, c = table.shape
    q = buckets.shape[1]
    out = torch.empty((r, q), dtype=torch.float32, device=table.device)
    if r and q:
        fn = _build.entry("sketch", "sketch_estimate_f32", _SIG)
        _build.launch("sketch_estimate_table", fn, table.device,
                      table.data_ptr(), buckets.data_ptr(), signs.data_ptr(),
                      out.data_ptr(), r, c, q)
    return out


def sketch_estimate_torch(table: torch.Tensor, buckets: torch.Tensor,
                          signs: torch.Tensor) -> torch.Tensor:
    """Plain version: the per-row gather times the signs, float32."""
    return torch.gather(table, 1, buckets).to(torch.float32) \
        * signs.to(torch.float32)


def sketch_estimate(table: torch.Tensor, buckets: torch.Tensor,
                    signs: torch.Tensor) -> torch.Tensor:
    """(R, Q) ``sign·table[r, bucket]``: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if table.is_cuda:
        return sketch_estimate_cuda(table, buckets, signs)
    return sketch_estimate_torch(table, buckets, signs)
