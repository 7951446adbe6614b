"""Heavy-hitter recovery: candidates × sketch → top-K cells."""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def exact_counts(key_hi: torch.Tensor, key_lo: torch.Tensor,
                 query_hi: torch.Tensor, query_lo: torch.Tensor
                 ) -> torch.Tensor:
    """Ground-truth frequency of each query key in the stream (a test
    oracle).  O(items × queries): test scale only."""
    eq = (key_hi[None, :] == query_hi[:, None]) & \
         (key_lo[None, :] == query_lo[:, None])
    return eq.to(torch.float32).sum(1)
