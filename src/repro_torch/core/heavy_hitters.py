"""Heavy-hitter recovery: candidates × sketch → top-K cells.

Single-shard and distributed variants.  The distributed variant is the
paper's geo-distributed topology over the ranks of a mesh:

    per rank  :  quantize → pack → local sketch update + local top-L
    data dim  :  all-reduce(sketch)      [merge within a data center]
    pod dim   :  all-reduce(sketch)      [merge across data centers]
    every rank:  all-gather(candidates) → dedupe → estimate on the merged
                 sketch → global top-K   [the master's extraction]

Every rank finishes with the same top-K list.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.candidates import Candidates
from repro_torch.core.sketch import CountSketch


class HeavyHitters(NamedTuple):
    """Top-K cells: packed keys, estimated counts, validity mask."""
    key_hi: torch.Tensor   # (K,) int64 holding uint32
    key_lo: torch.Tensor   # (K,) int64 holding uint32
    count: torch.Tensor    # (K,) float32, sketch-estimated frequency
    mask: torch.Tensor     # (K,) bool


def from_candidates(sk: CountSketch, cands: Candidates, k: int
                    ) -> HeavyHitters:
    """Dedupe candidate keys, estimate on the sketch, keep the top-k."""
    hi, lo, est = sketch_mod.topk_from_candidates(
        sk, cands.key_hi, cands.key_lo, k, cand_mask=cands.mask)
    mask = torch.isfinite(est) & (est > 0)
    return HeavyHitters(key_hi=hi, key_lo=lo,
                        count=torch.where(mask, est, 0.0), mask=mask)


def extract(sk: CountSketch, key_hi: torch.Tensor, key_lo: torch.Tensor,
            k: int, candidate_pool: Optional[int] = None,
            values: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None) -> HeavyHitters:
    """Single-shard convenience: exact local top-pool candidates, then
    the sketch-estimated top-k (pool >= k; default 2k for head-room)."""
    pool = candidate_pool or min(2 * k, key_hi.shape[0])
    cands = cand_mod.local_topk(key_hi, key_lo, pool,
                                values=values, mask=mask)
    return from_candidates(sk, cands, k)


def distributed_extract(sk_local: CountSketch, cands_local: Candidates,
                        k: int, merge_axes: Union[str, Sequence[str]], mesh
                        ) -> Tuple[HeavyHitters, CountSketch]:
    """Global heavy hitters from every rank's sketch and candidates:
    call it on every rank of ``mesh``.  ``merge_axes``: the mesh
    dimension(s) the data is sharded over, innermost (fast interconnect)
    first, e.g. ``("data", "pod")``.  Returns (the heavy hitters, the
    merged sketch), the same on every rank; the top-k runs on the merged
    table (K8 on the card)."""
    if isinstance(merge_axes, str):
        merge_axes = (merge_axes,)
    merged = sk_local
    for ax in merge_axes:           # hierarchical: data first, pod second
        merged = sketch_mod.psum_merge(merged, mesh, ax)
    gathered = cands_local
    for ax in merge_axes:
        gathered = cand_mod.all_gather(gathered, mesh, ax)
    return from_candidates(merged, gathered, k), merged


def exact_counts(key_hi: torch.Tensor, key_lo: torch.Tensor,
                 query_hi: torch.Tensor, query_lo: torch.Tensor
                 ) -> torch.Tensor:
    """Ground-truth frequency of each query key in the stream (a test
    oracle).  O(items × queries): test scale only."""
    eq = (key_hi[None, :] == query_hi[:, None]) & \
         (key_lo[None, :] == query_lo[:, None])
    return eq.to(torch.float32).sum(1)
