"""Sorted-COO segment reduction for the UMAP epoch loop.

The edge list is sorted by the reduction key ONCE at setup and each row's
slice boundaries are precomputed (:func:`row_bounds`); every epoch then
reduces per-edge values into per-point sums with :func:`segment_reduce`:
the hand-written CUDA kernel for tensors on the card, the plain cumsum
difference for tensors on the CPU.

UMAP reduces over BOTH endpoints of every edge, so :func:`edge_layout`
also builds the dst-sorted ordering and the gather permutation between
the two orderings: the second reduction is one gather and one more
segment reduce.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import segment_reduce as _segred


def row_bounds(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row slice boundaries of a sorted id list: row i owns entries
    [bounds[i], bounds[i+1]).  (n+1,) int32."""
    return torch.searchsorted(
        sorted_ids, torch.arange(n + 1, device=sorted_ids.device,
                                 dtype=sorted_ids.dtype)).to(torch.int32)


def segment_reduce(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-row sums of row-sorted per-edge values, (E,) or (E, D) ->
    (N,) or (N, D).  A CUDA tensor goes to the kernel, which launches or
    raises; a CPU tensor to the plain version."""
    if vals.is_cuda:
        return _segred.segment_reduce_cuda(vals, bounds)
    return _segred.segment_reduce_torch(vals, bounds)


class EdgeLayout(NamedTuple):
    """Bidirectional reduction plan over a fixed-shape COO edge list.

    * ``src``/``dst`` — the edge list, sorted by ``src`` (stable, so an
      already src-sorted input keeps its edge order);
    * ``src_bounds`` — row slices of the src-sorted order;
    * ``dst_order``/``dst_bounds`` — gather permutation into dst-sorted
      order plus its row slices:
      ``segment_reduce(vals[dst_order], dst_bounds)``.
    """
    src: torch.Tensor         # (E,) int64, sorted ascending
    dst: torch.Tensor         # (E,) int64 (src-sorted edge order)
    src_bounds: torch.Tensor  # (N+1,) int32
    dst_order: torch.Tensor   # (E,) int64: edge order -> dst-sorted order
    dst_bounds: torch.Tensor  # (N+1,) int32


def edge_layout(src: torch.Tensor, dst: torch.Tensor, n: int
                ) -> Tuple[EdgeLayout, torch.Tensor]:
    """Build the plan.  Returns (layout, order), ``order`` being the stable
    src-sort permutation: gather per-edge payloads with it once."""
    order = torch.sort(src, stable=True)[1]
    s = src[order].to(torch.int64)
    d = dst[order].to(torch.int64)
    dst_order = torch.sort(d, stable=True)[1]
    return EdgeLayout(
        src=s, dst=d,
        src_bounds=row_bounds(s, n),
        dst_order=dst_order,
        dst_bounds=row_bounds(d[dst_order], n)), order
