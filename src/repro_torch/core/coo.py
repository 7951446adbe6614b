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

The sparse tSNE backend's P is canonicalised once by :func:`dedupe_edges`
(sort by (src, dst), fold duplicate ordered pairs).

For the mesh-parallel embed stage, :class:`ShardedEdgeLayout` row-block
shards the same plan: rank s owns the contiguous row range
[s·rows_per, (s+1)·rows_per) and, because the edge list is src-sorted,
a contiguous slice of the edge array, padded to the longest block's
length Ep.  Each rank runs the same two segment reductions over its own
slice (:meth:`ShardedEdgeLayout.block`): the src side over local rows,
the dst side into a full-length partial over global rows that one
all-reduce totals.  Padded slots carry zero payload
(:func:`shard_payload`), so they vanish from every sum.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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


class EdgeBlock(NamedTuple):
    """One rank's slice of a :class:`ShardedEdgeLayout`, on its device:

    * ``src_bounds`` — LOCAL-row slices (src − row_offset) of the block's
      src-sorted edges: ``segment_reduce(vals, src_bounds)`` gives the
      block's (rows_per, ...) sums;
    * ``dst_order``/``dst_bounds`` — the block's dst-sorted order and its
      GLOBAL-row slices: ``segment_reduce(vals[dst_order], dst_bounds)``
      gives a full-length (n_padded, ...) partial;
    * ``edge_ids`` — each slot's global edge index (gather per-edge draws
      by it, so every edge sees the single-device draw);
    * ``edge_mask`` — False on padded slots."""
    src: torch.Tensor         # (Ep,) int64 global src ids, sorted
    dst: torch.Tensor         # (Ep,) int64 global dst ids
    edge_ids: torch.Tensor    # (Ep,) int64
    edge_mask: torch.Tensor   # (Ep,) bool
    src_bounds: torch.Tensor  # (rows_per+1,) int32
    dst_order: torch.Tensor   # (Ep,) int64
    dst_bounds: torch.Tensor  # (n_padded+1,) int32
    row_offset: int           # first global row of the block


class ShardedEdgeLayout(NamedTuple):
    """Row-block-sharded reduction plan over a src-sorted COO edge list:
    the (S, ...) host arrays of every block (see :class:`EdgeBlock` for
    each field's meaning).  Padded slots repeat the block's last real
    edge (edge 0 for an empty block), so their src stays inside the
    block and the per-block src-sorted order holds."""
    src: np.ndarray           # (S, Ep) int64
    dst: np.ndarray           # (S, Ep) int64
    edge_ids: np.ndarray      # (S, Ep) int64
    edge_mask: np.ndarray     # (S, Ep) bool
    src_bounds: np.ndarray    # (S, rows_per+1) int32
    dst_order: np.ndarray     # (S, Ep) int64
    dst_bounds: np.ndarray    # (S, n_padded+1) int32
    row_offset: np.ndarray    # (S,) int64

    @property
    def n_shards(self) -> int:
        return self.src.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.src_bounds.shape[1] - 1

    @property
    def n_padded(self) -> int:
        return self.dst_bounds.shape[1] - 1

    def block(self, s: int, device) -> EdgeBlock:
        """Block ``s`` as tensors on ``device``: all a rank keeps."""
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[s])).to(device)
        return EdgeBlock(src=t(self.src), dst=t(self.dst),
                         edge_ids=t(self.edge_ids),
                         edge_mask=t(self.edge_mask),
                         src_bounds=t(self.src_bounds),
                         dst_order=t(self.dst_order),
                         dst_bounds=t(self.dst_bounds),
                         row_offset=int(self.row_offset[s]))


def shard_edge_layout(src, dst, n: int, n_shards: int) -> ShardedEdgeLayout:
    """Build the row-block-sharded plan on the host, in numpy (the
    per-block edge counts depend on the data).  ``src``/``dst`` are the
    (E,) global edge list, ``src`` sorted ascending (as
    :func:`edge_layout` leaves it)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    e = src.shape[0]
    if e and np.any(src[1:] < src[:-1]):
        raise ValueError("shard_edge_layout needs a src-sorted edge list")
    rows_per = -(-n // n_shards)
    n_pad = rows_per * n_shards
    starts = np.searchsorted(src, np.arange(n_shards) * rows_per)
    ends = np.append(starts[1:], e)
    ep = max(1, int(np.max(ends - starts)))

    ids = np.empty((n_shards, ep), np.int64)
    mask = np.empty((n_shards, ep), bool)
    src_b = np.empty((n_shards, rows_per + 1), np.int32)
    dst_b = np.empty((n_shards, n_pad + 1), np.int32)
    dst_o = np.empty((n_shards, ep), np.int64)
    for s in range(n_shards):
        cnt = ends[s] - starts[s]
        last = max(starts[s], ends[s] - 1) if cnt else 0
        row = np.minimum(starts[s] + np.arange(ep), last)
        ids[s] = row
        mask[s] = np.arange(ep) < cnt
        local = src[row] - s * rows_per
        src_b[s] = np.searchsorted(local, np.arange(rows_per + 1))
        order = np.argsort(dst[row], kind="stable")
        dst_o[s] = order
        dst_b[s] = np.searchsorted(dst[row][order], np.arange(n_pad + 1))
    return ShardedEdgeLayout(
        src=src[ids], dst=dst[ids], edge_ids=ids, edge_mask=mask,
        src_bounds=src_b, dst_order=dst_o, dst_bounds=dst_b,
        row_offset=np.arange(n_shards, dtype=np.int64) * rows_per)


def shard_payload(layout, vals: torch.Tensor) -> torch.Tensor:
    """Gather a (E, ...) per-edge payload into the slot order of a
    :class:`ShardedEdgeLayout` ((S, Ep, ...)) or of one
    :class:`EdgeBlock` ((Ep, ...)), zeroed on padded slots: padded edges
    then add exactly nothing to any linear reduction.  Contiguous."""
    ids = torch.as_tensor(layout.edge_ids, device=vals.device)
    m = torch.as_tensor(layout.edge_mask, device=vals.device)
    out = vals[ids]
    m = m.reshape(m.shape + (1,) * (out.ndim - m.ndim))
    return torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                           device=out.device)).contiguous()


def dedupe_edges(src: torch.Tensor, dst: torch.Tensor, val: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical COO: sort by (src, dst), fold duplicate ordered pairs.

    Returns (src, dst, val) of the same fixed shape (E,), sorted
    lexicographically, each distinct ordered pair carrying its total on
    the first entry of its run and 0 on the duplicates.  The reference's
    ``jnp.lexsort((dst, src))`` is one stable sort of the int64 key
    src·2³² + dst (ids below 2³¹).  Setup only: the run-head fold is an
    ``index_add_``.  On a kNN-built edge list a pair occurs at most twice,
    and a two-term sum does not depend on its order, so there the result
    is bit-identical to the reference's.  The sorted key itself gives the
    sorted src and dst back (no gather of either), which keeps the peak
    near the inputs plus three keys: ~8 GB at path A's 1.8·10⁸ edges."""
    key, order = torch.sort(src.to(torch.int64) * (1 << 32)
                            + dst.to(torch.int64), stable=True)
    v = val[order]
    del order
    new_run = torch.ones_like(key, dtype=torch.bool)
    new_run[1:] = key[1:] != key[:-1]
    run_id = torch.cumsum(new_run, 0) - 1
    run_sum = torch.zeros_like(v).index_add_(0, run_id, v)
    v = torch.where(new_run, run_sum[run_id], 0.0)
    del new_run, run_id, run_sum
    # key = s·2³² + d with d in [−2³¹, 2³¹): s = ⌊(key + 2³¹) / 2³²⌋
    s = (key + (1 << 31)).bitwise_right_shift_(32)
    return s, key.sub_(s << 32), v
