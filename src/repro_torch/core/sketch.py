"""Count Sketch (Charikar-Chen-Farach-Colton) on tensors.

The paper's operations (§III-1): init / update / estimate / merge.  The
table is a linear operator over the frequency vector, so two sketches
built with the same hashes merge by addition.

On CUDA tensors the scatter of :func:`update` is the hand-written kernel
K7 (``kernels/sketch_update.py``: R hashes a key in registers, R atomic
adds, one launch a call) and all of :func:`estimate` is K8
(``kernels/sketch_estimate.py``: R hashes, R gathers and the median over
rows in registers, one launch a call); CPU tensors take their plain
twins (``index_add_``; hashes, ``torch.gather`` and a sort).  Integer
counts below 2**24 add to the same bits in any order, so tables match
the reference's bit for bit.
Weighted values (:func:`tensor_sketch_update`'s gradient coordinates)
agree to fp32 rounding only: the kernel's atomics add in a
schedule-dependent order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hashing, u64
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.candidates import (INVALID_KEY, KeyRuns, sorted_runs,
                                         topk_desc)
from repro_torch.kernels import sketch_estimate as _k8
from repro_torch.kernels.sketch_estimate import median_rows
from repro_torch.kernels.sketch_update import sketch_update


class CountSketch(NamedTuple):
    table: torch.Tensor                # (R, C) float32
    params: hashing.MulShiftParams     # R independent hash fns

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    @property
    def log2_cols(self) -> int:
        return int(self.table.shape[1]).bit_length() - 1


def init(params: hashing.MulShiftParams, log2_cols: int) -> CountSketch:
    """Zero (R, 2**log2_cols) table on the params' device.  Power-of-two
    columns make the bucket hash a shift."""
    if not 1 <= log2_cols <= 31:
        raise ValueError(f"log2_cols must be in [1, 31], got {log2_cols}")
    table = torch.zeros((params.rows, 1 << log2_cols),
                        device=params.a1_hi.device)
    return CountSketch(table=table, params=params)


def update(sk: CountSketch, key_hi: torch.Tensor, key_lo: torch.Tensor,
           values: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None) -> CountSketch:
    """S[r, h1_r(i)] += h2_r(i)·v_i for a batch of items (returns a new
    sketch; the input table is not modified)."""
    return update_(sk._replace(table=sk.table.clone()), key_hi, key_lo,
                   values=values, mask=mask)


def update_(sk: CountSketch, key_hi: torch.Tensor, key_lo: torch.Tensor,
            values: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None) -> CountSketch:
    """:func:`update` into ``sk``'s own table, in place: for a caller that
    owns the sketch (the streaming fold), as the reference's jitted fold
    donates its state.  Returns ``sk``."""
    v = torch.ones_like(key_hi, dtype=sk.table.dtype) if values is None \
        else values.to(sk.table.dtype)
    if mask is not None:
        v = v * mask.to(sk.table.dtype)
    sketch_update(sk.table, sk.params, key_hi.contiguous(),
                  key_lo.contiguous(), v.contiguous())
    return sk


def update_runs(sk: CountSketch, runs: KeyRuns) -> CountSketch:
    """Scatter pre-deduped sorted key runs.  Dead slots carry count 0 and
    scatter nothing (the kernel skips them)."""
    return update(sk, runs.key_hi, runs.key_lo, values=runs.count,
                  mask=runs.live)


def update_sorted(sk: CountSketch, key_hi: torch.Tensor,
                  key_lo: torch.Tensor, values: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> CountSketch:
    """Sort-based update from raw keys: one sort and run-length encoding
    aggregates duplicates, then one scatter of the runs.  Equivalent to
    :func:`update`."""
    runs = sorted_runs(key_hi, key_lo, values=values, mask=mask,
                       dtype=sk.table.dtype)
    return update_runs(sk, runs)


def merge(a: CountSketch, b: CountSketch) -> CountSketch:
    """``merge(S1, S2) = S1 + S2``.  The hash parameters must match; that
    is the caller's contract, as in the paper ("the hashing functions and
    the sketch matrix sizes must be the same")."""
    return a._replace(table=a.table + b.table)


def psum_merge(sk: CountSketch, mesh, axes) -> CountSketch:
    """Distributed merge over the ranks of mesh dimension(s) ``axes``: an
    all-reduce SUM of the (R, C) float32 table, innermost dimension
    first (the reference's hierarchical ``psum``).  Integer counts below
    2**24 add to the same bits in any order, so the merged table equals
    the sketch of the concatenated shards bit for bit."""
    return sk._replace(table=mesh_mod.all_reduce(sk.table, mesh, axes))


def l2_estimate(sk: CountSketch) -> torch.Tensor:
    """AMS-style ℓ₂ estimate: sqrt of the median over rows of Σ_c S[r,c]²
    (paper §II-3)."""
    return torch.sqrt(median_rows((sk.table.to(torch.float32) ** 2).sum(1)))


def estimate(sk: CountSketch, key_hi: torch.Tensor, key_lo: torch.Tensor
             ) -> torch.Tensor:
    """Median over rows of h2_r(i)·S[r, h1_r(i)] (``median_rows``).
    (items,) float32: one K8 launch on the card."""
    return _k8.estimate(sk.table, sk.params, key_hi.contiguous(),
                        key_lo.contiguous())


def topk_from_candidates(sk: CountSketch, cand_hi: torch.Tensor,
                         cand_lo: torch.Tensor, k: int,
                         cand_mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k candidate keys by sketch estimate.

    Dedupes candidates (the first of equal keys in sorted order counts),
    estimates each on the sketch and returns (hi, lo, est) of the k
    largest; padding and duplicates are masked out with -inf."""
    m = cand_hi.shape[0]
    order = torch.sort(u64.sort_key((cand_hi, cand_lo)), stable=True)[1]
    shi, slo = cand_hi[order], cand_lo[order]
    is_first = torch.ones((m,), dtype=torch.bool, device=shi.device)
    is_first[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    if cand_mask is not None:
        is_first &= cand_mask[order]
    est = torch.where(is_first, estimate(sk, shi, slo),
                      torch.tensor(float("-inf"), device=shi.device))
    kk = min(k, m)
    top_est, top_idx = topk_desc(est, kk)
    hi_out, lo_out = shi[top_idx], slo[top_idx]
    if kk < k:
        pad = k - kk
        fill = torch.full((pad,), INVALID_KEY, dtype=torch.int64,
                          device=shi.device)
        hi_out = torch.cat([hi_out, fill])
        lo_out = torch.cat([lo_out, fill])
        top_est = torch.cat([top_est, torch.full((pad,), float("-inf"),
                                                 device=shi.device)])
    return hi_out, lo_out, top_est


# coordinates a K7 / K8 launch of the dense-vector sketch: the reference
# sketches the whole vector at once, but at 1.1e9 coordinates the int64
# key limbs alone would be 17.6 GB and R·n exceeds 2**31
TENSOR_CHUNK = 1 << 24


def tensor_sketch_update(sk: CountSketch, grad_flat: torch.Tensor
                         ) -> CountSketch:
    """Sketch a dense vector (gradient compression): coordinate i is the
    key (hi 0, lo i) with value grad[i].  One K7 launch a chunk of
    ``TENSOR_CHUNK`` coordinates on the card; returns a new sketch."""
    table = sk.table.clone()
    n, chunk = grad_flat.shape[0], TENSOR_CHUNK
    for s in range(0, n, chunk):
        lo = torch.arange(s, min(n, s + chunk), dtype=torch.int64,
                          device=table.device)
        sketch_update(table, sk.params, torch.zeros_like(lo), lo,
                      grad_flat[s:s + chunk].to(table.dtype).contiguous())
    return sk._replace(table=table)


def tensor_sketch_estimate(sk: CountSketch, n: int) -> torch.Tensor:
    """Estimate all n coordinates of a sketched dense vector: (n,) float32,
    one K8 launch a chunk, which hashes the coordinates itself and writes
    its slice of the result."""
    out = torch.empty(n, dtype=torch.float32, device=sk.table.device)
    for s in range(0, n, TENSOR_CHUNK):
        _k8.estimate_range(sk.table, sk.params, s, out[s:s + TENSOR_CHUNK])
    return out
