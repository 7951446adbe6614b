"""Exact kNN graph and reverse-edge lookup for the UMAP fuzzy set.

:func:`knn_graph` is the brute-force O(N²·D) build, streamed in row
blocks so peak memory is O(block · N).  ``lax.top_k(-d, k)`` order is kept
exactly: each distance's IEEE total-order image and its column index are
packed into one int64, so every key is distinct and ``torch.topk`` has no
ties to break.  The approximate engine (``method="ann"``, and ``"auto"``
above 2¹⁶ points) is not ported yet (ROADMAP P9).

:func:`reverse_edge_values` gives the value of each directed edge's
reverse (0 if absent) without any (N, N) temporary.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.candidates import total_order
from repro_torch.core.tsne import pairwise_sq_dists

# reverse_edge_values packs edge (i, j) into the scalar i·n + j, whose
# max (n−1)·n + (n−1) = n² − 1 fits uint32 iff n ≤ 2¹⁶: the reference's
# bound for its sort branch, kept here so both ports take the same branch
PACKED_KEY_N_MAX = 1 << 16
# knn_graph(method="auto") is exact up to this many points, as in the
# reference (ann.AnnConfig.auto_threshold)
ANN_AUTO_THRESHOLD = 1 << 16


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
        # ascending (total order of d, column): lax.top_k(-d)'s order
        key = total_order(d) * (1 << 32) + col_ids
        top = torch.topk(key, k, dim=1, largest=False, sorted=True)[0]
        idx = top & 0xFFFFFFFF
        idx_out.append(idx)
        dist_out.append(torch.gather(d, 1, idx).clamp_(min=0.0).sqrt_())
    return torch.cat(idx_out), torch.cat(dist_out)


def knn_graph(x: torch.Tensor, k: int, *, block: Optional[int] = None,
              mesh=None, method: str = "exact", ann=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN graph excluding self: (indices (N, k) int64, dists (N, k)).

    ``k`` is clamped to N−1.  ``block`` streams the distance matrix in
    row chunks of that size (peak memory O(block · N))."""
    n = x.shape[0]
    k = min(int(k), max(n - 1, 1))
    if method not in ("exact", "auto", "ann"):
        raise ValueError(f"unknown kNN method: {method!r}")
    if method == "ann" or (method == "auto" and n > ANN_AUTO_THRESHOLD):
        raise NotImplementedError(
            f"approximate kNN (method={method!r} at N={n}) is not ported "
            f"yet: ROADMAP P9; use method='exact'")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded kNN is not ported yet: "
                                  "ROADMAP P12")
    return _knn_rows(x, torch.arange(n, device=x.device), x, k, block)


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
