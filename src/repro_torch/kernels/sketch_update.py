"""Hash-and-accumulate into a Count Sketch table (K7): the CUDA kernel
and its plain twin.

For (N,) 64-bit keys (uint32 limbs in int64) and (N,) float32 values,
``table[r, h1_r(key)] += h2_r(key)·value`` for every row r of an (R, C)
float32 table, in place: ``sketch.update``'s scatter, and the reference's
``repro.kernels.sketch_update`` behind ``ops.sketch_update_fused``.

* :func:`sketch_update_cuda` launches ``csrc/sketch.cu`` (one thread per
  item, R hashes in registers, R atomic adds, the hash parameters read
  from their six limb tensors; the source note says what bounds it).
  CUDA tensors only.
* :func:`sketch_update_torch` is the plain version: hashes in chunks of
  items, then one ``index_add_`` a chunk on the flattened table
  (``repro.kernels.ref.sketch_update`` with the hashes taken inside).
* :func:`sketch_update` dispatches by device: a CUDA tensor launches the
  kernel or raises, a CPU tensor takes the twin.

Integer-valued sums are exact in any order while partial sums stay below
2**24, so integer tables agree bit for bit; weighted values to fp32
rounding (atomics add in a schedule-dependent order).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import MulShiftParams
from repro_torch.kernels import _build
from repro_torch.kernels.hash_points import check_log2_cols, check_params

# (key_hi, key_lo, values, six param limbs, table, n, rows, log2_cols,
#  stream)
_SIG = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
# items hashed per pass of the plain version: (R=16, 2**21) int64
# temporaries are 256 MiB each
_HASH_CHUNK = 1 << 21


def _log2_cols(table: torch.Tensor) -> int:
    cols = int(table.shape[1])
    if cols & (cols - 1):
        raise ValueError(f"sketch_update: the table needs a power-of-two "
                         f"column count, got {cols}")
    return cols.bit_length() - 1


def sketch_update_cuda(table: torch.Tensor, params: MulShiftParams,
                       key_hi: torch.Tensor, key_lo: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Add the items into ``table`` in place by the hand-written kernel;
    returns ``table``."""
    ts = (table, key_hi, key_lo, values)
    if not all(t.is_cuda for t in ts):
        raise ValueError("sketch_update_cuda takes CUDA tensors; got "
                         + ", ".join(str(t.device) for t in ts))
    if len({t.device for t in ts}) != 1:
        raise ValueError("sketch_update: tensors on different devices")
    check_params("sketch_update", params, table.device)
    if table.dtype != torch.float32 or values.dtype != torch.float32:
        raise ValueError(f"sketch_update: table and values must be float32, "
                         f"got {table.dtype} and {values.dtype}")
    if key_hi.dtype != torch.int64 or key_lo.dtype != torch.int64:
        raise ValueError(f"sketch_update: keys must be int64 limbs, got "
                         f"{key_hi.dtype} and {key_lo.dtype}")
    n = key_hi.shape[0]
    if table.dim() != 2 or table.shape[0] != params.rows or \
            key_hi.shape != (n,) or key_lo.shape != (n,) or \
            values.shape != (n,):
        raise ValueError(f"sketch_update: need table ({params.rows}, C) and "
                         f"keys and values (N,); got {tuple(table.shape)}, "
                         f"{tuple(key_hi.shape)}, {tuple(key_lo.shape)}, "
                         f"{tuple(values.shape)}")
    log2_cols = _log2_cols(table)
    check_log2_cols("sketch_update", log2_cols)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sketch_update: tensors must be contiguous")
    if n:
        fn = _build.entry("sketch", "sketch_update_f32", _SIG)
        _build.launch("sketch_update_table", fn, table.device,
                      key_hi.data_ptr(), key_lo.data_ptr(),
                      values.data_ptr(), *(p.data_ptr() for p in params),
                      table.data_ptr(), n, params.rows, log2_cols)
    return table


def sketch_update_torch(table: torch.Tensor, params: MulShiftParams,
                        key_hi: torch.Tensor, key_lo: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """Plain version, in place on ``table`` (any float dtype); returns
    ``table``."""
    log2_cols = _log2_cols(table)
    flat = table.view(-1)
    row_base = (torch.arange(table.shape[0], device=table.device)
                << log2_cols)[:, None]
    v = values.to(table.dtype)
    for s in range(0, key_hi.shape[0], _HASH_CHUNK):
        sl = slice(s, s + _HASH_CHUNK)
        buckets, signs = hashing.hashes(params, key_hi[sl], key_lo[sl],
                                        log2_cols)
        flat.index_add_(0, (row_base | buckets).reshape(-1),
                        (signs.to(flat.dtype) * v[sl][None, :]).reshape(-1))
    return table


def sketch_update(table: torch.Tensor, params: MulShiftParams,
                  key_hi: torch.Tensor, key_lo: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """Add sign·value of each item into ``table`` in place: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if table.is_cuda:
        return sketch_update_cuda(table, params, key_hi, key_lo, values)
    return sketch_update_torch(table, params, key_hi, key_lo, values)
