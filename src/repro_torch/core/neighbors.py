"""kNN graph, kNN query and reverse-edge lookup for the embedders.

:func:`knn_graph` picks the build with ``method=``, as the reference
does:

* ``"exact"`` — the brute-force O(N²·D) pass, streamed in row blocks so
  peak memory is O(block · N).  ``lax.top_k(-d, k)`` order is kept
  exactly (:func:`candidates.smallest_k`);
* ``"ann"`` — the approximate engine :mod:`repro_torch.core.ann`
  (grid-cell bucketing with the distance-tile kernel K4 + NN-descent);
* ``"auto"`` — exact up to ``AnnConfig.auto_threshold`` points, ann
  above.

:func:`knn_query` is the asymmetric query-vs-corpus kNN (no
self-exclusion) with the same dispatch.  :func:`reverse_edge_values`
gives the value of each directed edge's reverse (0 if absent) without
any (N, N) temporary.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import ann as ann_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import spans
from repro_torch.core.candidates import smallest_k
from repro_torch.core.tsne import pairwise_sq_dists

# reverse_edge_values packs edge (i, j) into the scalar i·n + j, whose
# max (n−1)·n + (n−1) = n² − 1 fits uint32 iff n ≤ 2¹⁶: the reference's
# bound for its sort branch, kept here so both ports take the same branch
PACKED_KEY_N_MAX = 1 << 16
METHODS = ("exact", "auto", "ann")


def _knn_rows(x_rows: torch.Tensor, row_ids: torch.Tensor, x: torch.Tensor,
              k: int, block: Optional[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN of ``x_rows`` (carrying global ``row_ids``) against all of ``x``,
    ``block`` rows at a time; self-pairs (row id == column id) excluded."""
    m, n = x_rows.shape[0], x.shape[0]
    col_ids = torch.arange(n, device=x.device)
    step = m if block is None or block >= m else block
    idx_out, dist_out = [], []
    for s in range(0, m, step):
        d = pairwise_sq_dists(x_rows[s:s + step], x)          # (B, N)
        d = d.masked_fill_(row_ids[s:s + step, None] == col_ids[None, :],
                           float("inf"))
        top, idx = smallest_k(d, k)
        idx_out.append(idx)
        dist_out.append(top.clamp_(min=0.0).sqrt_())
    return torch.cat(idx_out), torch.cat(dist_out)


def _use_ann(method: str, n: int, ann) -> Optional[ann_mod.AnnConfig]:
    """The ann config when ``method`` picks the approximate engine at
    ``n`` points, else None (the exact build)."""
    if method not in METHODS:
        raise ValueError(f"unknown kNN method: {method!r}")
    if method == "exact":
        return None
    cfg = ann if ann is not None else ann_mod.AnnConfig()
    return cfg if method == "ann" or n > cfg.auto_threshold else None


@spans.spanned("knn")
def knn_graph(x: torch.Tensor, k: int, *, block: Optional[int] = None,
              mesh=None, method: str = "exact", ann=None,
              ann_draws: Optional[ann_mod.AnnDraws] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN graph excluding self: (indices (N, k) int64, dists (N, k)).

    ``k`` is clamped to N−1.  ``method`` is ``"exact"`` (``block``
    streams the distance matrix in row chunks: peak O(block · N)),
    ``"ann"`` (``ann`` an optional ``AnnConfig``, ``ann_draws`` optional
    ``AnnDraws``) or ``"auto"`` (exact up to ``AnnConfig.auto_threshold``
    points, ann above).

    With ``mesh`` (a 1-D embed mesh, see ``core.mesh``; every rank passes
    the same ``x``) the exact build is row-block sharded: each rank
    computes its padded row block against the whole ``x``, and one
    all-gather of the indices and distances makes the graph whole on
    every rank, each row as the single-device build gives it.  The
    approximate build shards its tile scan and its refinement
    (``core.ann``) and equals the single-device graph bit for bit."""
    n = x.shape[0]
    k = min(int(k), max(n - 1, 1))
    cfg = _use_ann(method, n, ann)
    mesh = mesh_mod.resolve_mesh(mesh)
    if cfg is not None:
        return ann_mod.ann_knn_graph(x, k, cfg, mesh=mesh, draws=ann_draws)
    if mesh is None:
        return _knn_rows(x, torch.arange(n, device=x.device), x, k, block)
    axis = mesh_mod.mesh_axis(mesh)
    rows_per, _ = mesh_mod.row_block(n, mesh_mod.axis_size(mesh, axis))
    lo = mesh.get_local_rank(axis) * rows_per
    ids = torch.arange(lo, lo + rows_per, device=x.device)
    x_blk = x[lo:lo + rows_per]
    # padded rows carry id -1 (never a column id); their rows are cut
    x_blk = torch.cat([x_blk, x.new_zeros((rows_per - x_blk.shape[0],
                                           x.shape[1]))])
    ids = torch.where(ids < n, ids, -1)
    b = None if block is None else min(block, rows_per)
    idx, dist = _knn_rows(x_blk, ids, x, k, b)
    return (mesh_mod.all_gather(idx, mesh, axis)[:n],
            mesh_mod.all_gather(dist, mesh, axis)[:n])


def knn_query(q: torch.Tensor, x: torch.Tensor, k: int, *,
              block: Optional[int] = None, method: str = "exact",
              ann=None, corpus_graph: Optional[torch.Tensor] = None,
              ann_draws: Optional[ann_mod.AnnDraws] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of the frozen corpus ``x`` (N, D) for each query in
    ``q`` (Q, D): (indices (Q, k) int64 into x, dists (Q, k)).

    No self-exclusion: a query identical to a corpus row returns that
    row at distance 0, so ``k`` clamps to N.  ``method``/``ann`` as in
    :func:`knn_graph`; the exact path streams ``block``-query chunks
    (peak O(block · N)); ``corpus_graph`` (corpus kNN indices) feeds the
    ann path's expansion round."""
    n = x.shape[0]
    k = min(int(k), max(n, 1))
    cfg = _use_ann(method, n, ann)
    if cfg is not None:
        return ann_mod.ann_knn_query(q, x, k, cfg, corpus_graph=corpus_graph,
                                     draws=ann_draws)
    # query ids of −1 never equal a column id ≥ 0: no exclusion
    qids = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    return _knn_rows(q, qids, x, k, block)


def reverse_edge_values(knn_idx: torch.Tensor, vals_nk: torch.Tensor,
                        rows: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, n: int) -> torch.Tensor:
    """Value of each directed edge's reverse (0 if absent), sparse.

    Up to ``PACKED_KEY_N_MAX`` points: pack each edge (i, j) into
    i·n + j, sort once and binary-search every reverse key.  Above it:
    the reverse of (i, j) can only live in j's kNN row, so compare
    knn_idx[j] against i (E·k work)."""
    e = rows.shape[0]
    if n <= PACKED_KEY_N_MAX:
        fwd = rows.to(torch.int64) * n + cols
        rev = cols.to(torch.int64) * n + rows
        sorted_keys, order = torch.sort(fwd)
        sorted_vals = vals[order]
        pos = torch.searchsorted(sorted_keys, rev).clamp_(max=e - 1)
        hit = sorted_keys[pos] == rev
        return torch.where(hit, sorted_vals[pos], 0.0)
    match = knn_idx[cols] == rows[:, None]                 # (E, k)
    return torch.where(match, vals_nk[cols], 0.0).sum(1)
