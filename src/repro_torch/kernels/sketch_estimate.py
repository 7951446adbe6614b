"""Count Sketch point estimates (K8): the fused CUDA kernel and its plain
twin.

For an (R, C = 2**l) float32 table and the R hashes it was built with,
the estimate of a 64-bit key is the median over rows of
``sign_r(key)·table[r, bucket_r(key)]``: ``sketch.estimate``, and the
reference's ``repro.kernels.sketch_estimate`` behind
``ops.sketch_estimate_mxu`` with the median ``ops.py`` takes after it.

* :func:`estimate_cuda` launches ``csrc/sketch.cu`` for explicit keys
  (uint32 limbs in int64), :func:`estimate_range_cuda` for the keys
  (0, start + j), j < n, written into the caller's (n,) slice: one
  thread a query hashes, gathers its R cells and takes the median in
  registers (the source note says what bounds it); above
  :data:`MAX_ROWS` rows a warp serves a query, its R values in a scratch
  this wrapper allocates.  CUDA tensors only; any R >= 1.
* :func:`estimate_torch` and :func:`estimate_range_torch` are the plain
  versions, the chain the kernel replaced: ``hashing.hashes`` →
  :func:`sketch_estimate_torch` (the (R, Q) signed gather,
  ``repro.kernels.ref.sketch_estimate``) → :func:`median_rows`.
* :func:`estimate` and :func:`estimate_range` dispatch by device: a
  CUDA table launches the kernel or raises, a CPU table takes the twin.

The two agree bit for bit, signed zeros included: a product with ±1 is
exact, and the kernel's median ranks the values as :func:`median_rows`'
stable sort orders them and rounds the mean of the middle two as it
does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashing
from repro_torch.core.hashing import MulShiftParams
from repro_torch.kernels import _build
from repro_torch.kernels.hash_points import check_log2_cols, check_params

# (table, key_hi, key_lo, six param limbs, out, scratch, n, start, rows,
#  log2_cols, stream)
_SIG = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
# the kernel's kMaxEstimateRows: R other than 8 and 16 keeps a block's
# values in shared memory, which holds 64 columns of up to 128 rows; a
# larger R takes the warp-a-query path and its scratch
MAX_ROWS = 128
# implicit keys are (0, start + j) with a uint32 low limb
_KEY_SPACE = 1 << 32


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: a stable sort (−0.0 and +0.0 equal, in
    row order), then the mean of the two middle values as (low + high) *
    0.5 (``torch.median`` returns the lower)."""
    s = torch.sort(x, dim=0, stable=True)[0]
    r = x.shape[0]
    return (s[(r - 1) // 2] + s[r // 2]) * 0.5


def sketch_estimate_torch(table: torch.Tensor, buckets: torch.Tensor,
                          signs: torch.Tensor) -> torch.Tensor:
    """(R, Q) ``sign·table[r, bucket]`` in float32: the per-row gather
    times the signs."""
    return torch.gather(table, 1, buckets).to(torch.float32) \
        * signs.to(torch.float32)


def _log2_cols(op: str, table: torch.Tensor) -> int:
    cols = int(table.shape[1])
    if cols & (cols - 1):
        raise ValueError(f"{op}: the table needs a power-of-two column "
                         f"count, got {cols}")
    return cols.bit_length() - 1


def _check_range(op: str, start: int, n: int) -> None:
    if start < 0 or start + n > _KEY_SPACE:
        raise ValueError(f"{op}: the keys (0, start + j) need 0 <= start and "
                         f"start + n <= 2^32; got start {start}, n {n}")


def _check_table(op: str, table: torch.Tensor, params: MulShiftParams,
                 tensors) -> int:
    """Device, dtype, shape and layout of everything the kernel reads;
    returns log2 C."""
    ts = (table, *tensors)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{op} takes CUDA tensors; got "
                         + ", ".join(str(t.device) for t in ts))
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{op}: tensors on different devices")
    check_params(op, params, table.device)
    if table.dtype != torch.float32:
        raise ValueError(f"{op}: table must be float32, got {table.dtype}")
    if table.dim() != 2 or table.shape[0] != params.rows:
        raise ValueError(f"{op}: need table ({params.rows}, C); got "
                         f"{tuple(table.shape)}")
    log2_cols = _log2_cols(op, table)
    check_log2_cols(op, log2_cols)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{op}: tensors must be contiguous")
    return log2_cols


def _launch(table, params, key_hi, key_lo, out, start, log2_cols):
    n = out.shape[0]
    scratch = None
    if params.rows > MAX_ROWS:        # a row of R floats a resident warp
        rows = _build.entry("sketch", "sketch_estimate_scratch_rows",
                            [ctypes.c_longlong],
                            restype=ctypes.c_longlong)(n)
        scratch = torch.empty((rows, params.rows), dtype=torch.float32,
                              device=table.device)
    fn = _build.entry("sketch", "sketch_estimate_median_f32", _SIG)
    _build.launch("sketch_estimate_table", fn, table.device,
                  table.data_ptr(), key_hi, key_lo,
                  *(p.data_ptr() for p in params), out.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  n, start, params.rows, log2_cols)


def estimate_cuda(table: torch.Tensor, params: MulShiftParams,
                  key_hi: torch.Tensor, key_lo: torch.Tensor
                  ) -> torch.Tensor:
    """(Q,) float32 estimates of the keys by the hand-written kernel."""
    op = "sketch_estimate"
    log2_cols = _check_table(op, table, params, (key_hi, key_lo))
    if key_hi.dtype != torch.int64 or key_lo.dtype != torch.int64:
        raise ValueError(f"{op}: keys must be int64 limbs, got "
                         f"{key_hi.dtype} and {key_lo.dtype}")
    q = key_hi.shape[0]
    if key_hi.shape != (q,) or key_lo.shape != (q,):
        raise ValueError(f"{op}: need keys (Q,); got {tuple(key_hi.shape)}, "
                         f"{tuple(key_lo.shape)}")
    out = torch.empty((q,), dtype=torch.float32, device=table.device)
    if q:
        _launch(table, params, key_hi.data_ptr(), key_lo.data_ptr(), out, 0,
                log2_cols)
    return out


def estimate_range_cuda(table: torch.Tensor, params: MulShiftParams,
                        start: int, out: torch.Tensor) -> torch.Tensor:
    """The estimates of the keys (0, start + j), j < n, by the
    hand-written kernel, written into ``out`` ((n,) float32); returns
    ``out``."""
    op = "sketch_estimate_range"
    log2_cols = _check_table(op, table, params, (out,))
    if out.dtype != torch.float32 or out.dim() != 1:
        raise ValueError(f"{op}: out must be (n,) float32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    n = out.shape[0]
    _check_range(op, start, n)
    if n:
        _launch(table, params, None, None, out, start, log2_cols)
    return out


def estimate_torch(table: torch.Tensor, params: MulShiftParams,
                   key_hi: torch.Tensor, key_lo: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version: hash, signed gather, median over rows; (Q,)
    float32."""
    buckets, signs = hashing.hashes(params, key_hi, key_lo,
                                    _log2_cols("sketch_estimate", table))
    return median_rows(sketch_estimate_torch(table, buckets, signs))


def estimate_range_torch(table: torch.Tensor, params: MulShiftParams,
                         start: int, n: int) -> torch.Tensor:
    """Plain version of :func:`estimate_range_cuda`: builds the keys (0,
    start + j), j < n, and estimates them; (n,) float32."""
    _check_range("sketch_estimate_range", start, n)
    lo = torch.arange(start, start + n, dtype=torch.int64,
                      device=table.device)
    return estimate_torch(table, params, torch.zeros_like(lo), lo)


def estimate(table: torch.Tensor, params: MulShiftParams,
             key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """(Q,) median over rows of ``sign·table[r, bucket]`` at the keys: the
    kernel for a CUDA table, the plain version for a CPU table."""
    if table.is_cuda:
        return estimate_cuda(table, params, key_hi, key_lo)
    return estimate_torch(table, params, key_hi, key_lo)


def estimate_range(table: torch.Tensor, params: MulShiftParams, start: int,
                   out: torch.Tensor) -> torch.Tensor:
    """The estimates of the keys (0, start + j), j < n, into ``out``
    ((n,) float32): the kernel for a CUDA table, the plain version for a
    CPU table.  Returns ``out``."""
    if table.is_cuda:
        return estimate_range_cuda(table, params, start, out)
    return out.copy_(estimate_range_torch(table, params, start,
                                          out.shape[0]))
