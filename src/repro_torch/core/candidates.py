"""Candidate tracking: sorted key runs, the exact local top-k, reservoir
merges.

The Count Sketch estimates frequencies but stores no key identities, so
each shard extracts its exact top-L keys next to the sketch and the heavy
hitter stage re-estimates them on the sketch.  The currency is
:class:`KeyRuns`, the output of ONE sort + run-length encoding over the
keys (:func:`sorted_runs`); the same runs feed the sketch scatter
(``sketch.update_runs``), the candidate top-k (:func:`topk_from_runs`)
and, on the streaming fold, the bounded reservoir merge
(:func:`merge_runs`: a sorted merge against a reservoir kept key-sorted,
no second sort of the chunk).

Bit-identity with the reference (``repro.core.candidates``) rests on two
orders:

* ``jnp.lexsort((lo, hi))`` is a stable sort of ``u64.sort_key``;
* ``lax.top_k`` ranks by IEEE total order (+0.0 above −0.0) and puts the
  lower index first among ties: :func:`topk_desc` sorts the total-order
  integer image of the scores, stable and descending.  ``torch.topk`` is
  not used on tied keys, as its tie order on CUDA is unspecified;
  :func:`smallest_k` gives it distinct keys only.

Everything is static-shape: L is fixed, and sets with fewer than L
distinct keys pad with an invalid key and mask=False.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import mesh as mesh_mod
from repro_torch.core import u64

INVALID_KEY = 0xFFFFFFFF


class Candidates(NamedTuple):
    """Top-L locally frequent keys of one shard (padded, mask-carrying),
    count-descending."""
    key_hi: torch.Tensor    # (L,) int64 holding uint32
    key_lo: torch.Tensor    # (L,) int64 holding uint32
    count: torch.Tensor     # (L,) float32, exact local count
    mask: torch.Tensor      # (L,) bool, False for padding

    @property
    def capacity(self) -> int:
        """Reservoir size L."""
        return self.key_hi.shape[0]

    def merge_topk(self, other: "Candidates", k: int) -> "Candidates":
        """Reservoir merge: see :func:`merge_topk`."""
        return merge_topk(self, other, k=k)


class KeyRuns(NamedTuple):
    """Run-length-encoded sorted keys (see :func:`sorted_runs`).

    ``key_hi/key_lo[j]`` for j < num_runs is the j-th distinct key in
    ascending (hi, lo) order and ``count[j]`` its masked value sum;
    positions j >= num_runs repeat the largest sorted key with count 0."""
    key_hi: torch.Tensor    # (n,) int64
    key_lo: torch.Tensor    # (n,) int64
    count: torch.Tensor     # (n,) summed value per run (0 past num_runs)
    live: torch.Tensor      # (n,) bool, position < num_runs

    @property
    def size(self) -> int:
        return self.key_hi.shape[0]


def total_order(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 whose order is IEEE total order (−0.0 < +0.0),
    the order ``lax.top_k`` and ``lax.sort`` rank floats by."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def topk_desc(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(score, k)`` along the last dim of float32 ``score``: the
    k largest in total order, lower index first among ties."""
    idx = torch.sort(total_order(score), dim=-1, descending=True,
                     stable=True)[1][..., :k]
    return torch.gather(score, -1, idx), idx


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``-lax.top_k(-d, k)`` along the last dim of float32 ``d``: the k
    smallest in ascending IEEE total order, lower index first among ties
    (+inf padding included).  Each entry's total-order image and its
    index are packed into one distinct int64, so ``torch.topk`` has no
    ties to break.  Returns (values, positions int64)."""
    col = torch.arange(d.shape[-1], device=d.device)
    key = total_order(d) * (1 << 32) + col
    pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)[0]
    pos &= 0xFFFFFFFF
    return torch.gather(d, -1, pos), pos


def empty(k: int, device=None) -> Candidates:
    """An all-padding candidate set of capacity k."""
    full = torch.full((k,), INVALID_KEY, dtype=torch.int64, device=device)
    return Candidates(key_hi=full, key_lo=full.clone(),
                      count=torch.zeros((k,), device=device),
                      mask=torch.zeros((k,), dtype=torch.bool, device=device))


def sorted_runs(key_hi: torch.Tensor, key_lo: torch.Tensor,
                values: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                dtype=torch.float32, assume_hi_zero: bool = False) -> KeyRuns:
    """Sort (hi, lo) keys once, mark run heads, sum each run's values.

    ``values`` defaults to 1 (counting); ``mask`` zeroes padding rows,
    which still occupy sort slots.  ``assume_hi_zero`` (keys known to fit
    the low limb, ``dims·bits_per_dim <= 32``) sorts the low limb alone;
    with ``key_hi ≡ 0`` both paths are the same stable permutation."""
    n = key_hi.shape[0]
    dev = key_hi.device
    v = torch.ones((n,), dtype=dtype, device=dev) if values is None \
        else values.to(dtype)
    if mask is not None:
        v = v * mask.to(dtype)
    order = torch.sort(key_lo if assume_hi_zero else u64.sort_key(
        (key_hi, key_lo)), stable=True)[1]
    shi, slo, sv = key_hi[order], key_lo[order], v[order]
    new_run = torch.ones((n,), dtype=torch.bool, device=dev)
    if assume_hi_zero:
        new_run[1:] = slo[1:] != slo[:-1]
    else:
        new_run[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    run_id = torch.cumsum(new_run, 0) - 1
    # per-run sums by an atomic scatter: exact for integer counts below
    # 2**24, where every order of addition gives the same bits
    run_sum = torch.zeros((n,), dtype=dtype, device=dev).index_add_(
        0, run_id, sv)
    # representative key of each run = its first occurrence; dead slots
    # clip to n-1, repeating the largest sorted key
    first_idx = torch.searchsorted(
        run_id, torch.arange(n, device=dev)).clamp_(0, max(n - 1, 0))
    num_runs = run_id[-1:] + 1 if n else run_id
    return KeyRuns(key_hi=shi[first_idx], key_lo=slo[first_idx],
                   count=run_sum,
                   live=torch.arange(n, device=dev) < num_runs)


def topk_from_runs(runs: KeyRuns, k: int, return_dropped: bool = False):
    """Exact top-k runs by count, count-descending, padded to k with
    invalid keys + mask=False.

    ``return_dropped=True`` also returns the largest live count NOT
    selected (0.0 when nothing is truncated): any key with a larger count
    is certain to be among the candidates."""
    n = runs.size
    live = runs.live & (runs.count > 0)
    score = torch.where(live, runs.count.to(torch.float32),
                        torch.tensor(float("-inf"), device=live.device))
    kk = min(k, n)
    kk2 = min(k + 1, n)                 # one extra for the drop watermark
    top_score, top_idx = topk_desc(score, kk2)
    dropped = top_score[kk2 - 1].clamp(min=0.0) if kk2 > kk \
        else torch.zeros((), device=score.device)
    top_score, top_idx = top_score[:kk], top_idx[:kk]
    cmask = torch.isfinite(top_score)
    invalid = torch.tensor(INVALID_KEY, device=score.device)
    out = Candidates(
        key_hi=torch.where(cmask, runs.key_hi[top_idx], invalid),
        key_lo=torch.where(cmask, runs.key_lo[top_idx], invalid),
        count=torch.where(cmask, top_score, 0.0),
        mask=cmask)
    if kk < k:                          # fewer items than the pool: pad
        out = concat(out, empty(k - kk, device=score.device))
    if return_dropped:
        return out, dropped
    return out


def local_topk(key_hi: torch.Tensor, key_lo: torch.Tensor, k: int,
               values: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> Candidates:
    """Exact top-k distinct keys by total count/value."""
    return topk_from_runs(
        sorted_runs(key_hi, key_lo, values=values, mask=mask), k)


def concat(*cands: Candidates) -> Candidates:
    """Concatenate candidate sets field by field."""
    return Candidates(*[torch.cat(f) for f in zip(*cands)])


def runs_from_candidates(c: Candidates) -> KeyRuns:
    """View a candidate set of DISTINCT keys (a reservoir or a top-k, in
    any order) as :class:`KeyRuns` for :func:`merge_runs`: one stable
    sort puts the live keys ascending; INVALID padding sorts last with
    count 0."""
    order = torch.sort(u64.sort_key((c.key_hi, c.key_lo)), stable=True)[1]
    return KeyRuns(key_hi=c.key_hi[order], key_lo=c.key_lo[order],
                   count=torch.where(c.mask, c.count, 0.0)[order].to(
                       torch.float32),
                   live=c.mask[order])


def merge_topk(a: Candidates, b: Candidates, k: int) -> Candidates:
    """Unordered reservoir merge: concat → sort → dedupe (equal keys sum
    their counts) → exact top-k, count-descending.  A key held by either
    side keeps its whole count, so while the distinct keys seen stay ≤ k
    the reservoir is the exact top-k of the whole stream."""
    c = concat(a, b)
    return local_topk(c.key_hi, c.key_lo, k, values=c.count, mask=c.mask)


def _searchsorted_pair(b_hi: torch.Tensor, b_lo: torch.Tensor,
                       q_hi: torch.Tensor, q_lo: torch.Tensor,
                       side: str) -> torch.Tensor:
    """searchsorted over (hi, lo) uint32 pairs sorted as 64-bit values:
    ``torch.searchsorted`` on their :func:`u64.sort_key` (the reference
    binary-searches with a two-limb comparator).  ``side="left"`` counts
    the entries of b strictly below each query, ``"right"`` those ≤ it."""
    return torch.searchsorted(u64.sort_key((b_hi, b_lo)),
                              u64.sort_key((q_hi, q_lo)), side=side)


def merge_runs(pool: Candidates, runs: KeyRuns, k: int
               ) -> Tuple[Candidates, torch.Tensor]:
    """Bounded reservoir merge without a sort: the streaming fold's step.

    ``pool`` MUST be key-sorted (live keys ascending, padding at the end:
    :func:`empty` starts so and this function keeps it so); ``runs`` come
    deduped and sorted from :func:`sorted_runs`.

    1. each side's slots are ranked in the combined order by a binary
       search of the other side (the pool first among equal keys) and
       scattered there;
    2. equal keys are adjacent, at most two with a nonzero count (the
       pool's and the chunk's), so a run head's total is its count plus
       its successor's when that holds the same key;
    3. the k largest live totals are kept, the lower merged position
       (the smaller key) first among equal totals, as ``lax.top_k``
       breaks ties in the reference: their float32 bits and their
       position are packed into one distinct int64, so ``torch.topk`` has
       no ties to break;
    4. the kept heads compact to the front in merged order (a cumsum and
       a binary search, no host sync), so the result stays key-sorted.

    The live (key → count) set is bit for bit the reference's
    (``repro.core.candidates.merge_runs``) and :func:`merge_topk`'s; only
    the storage order differs from the latter.  Returns ``(merged,
    evicted_max)``: the largest total evicted by THIS merge (0.0 if
    none), the space-saving diagnostic ``stream.IngestState`` keeps."""
    pool_n, n = pool.capacity, runs.size
    tot = pool_n + n
    dev = pool.key_hi.device
    p_cnt = pool.count * pool.mask.to(pool.count.dtype)
    r_cnt = runs.count.to(torch.float32)

    # 1. merged order: ranks by cross binary search (pool first on ties)
    pos_p = torch.arange(pool_n, device=dev) + _searchsorted_pair(
        runs.key_hi, runs.key_lo, pool.key_hi, pool.key_lo, "left")
    pos_r = torch.arange(n, device=dev) + _searchsorted_pair(
        pool.key_hi, pool.key_lo, runs.key_hi, runs.key_lo, "right")
    m_hi = torch.empty((tot,), dtype=torch.int64, device=dev)
    m_lo = torch.empty_like(m_hi)
    m_cnt = torch.empty((tot,), dtype=torch.float32, device=dev)
    for dst, src_p, src_r in ((m_hi, pool.key_hi, runs.key_hi),
                              (m_lo, pool.key_lo, runs.key_lo),
                              (m_cnt, p_cnt, r_cnt)):
        dst[pos_p] = src_p
        dst[pos_r] = src_r

    # 2. pair-add dedupe: a head's total is its count plus its same-key
    # successor's
    same_next = torch.zeros((tot,), dtype=torch.bool, device=dev)
    same_next[:-1] = (m_hi[1:] == m_hi[:-1]) & (m_lo[1:] == m_lo[:-1])
    new_run = torch.ones((tot,), dtype=torch.bool, device=dev)
    new_run[1:] = ~same_next[:-1]
    nxt = torch.zeros_like(m_cnt)
    nxt[:-1] = m_cnt[1:]
    csum = m_cnt + torch.where(same_next, nxt, 0.0)
    live = new_run & (csum > 0)

    # 3. the k largest live totals, lower position first among equals
    pos = torch.arange(tot, device=dev)
    rank_key = torch.where(
        live, csum.view(torch.int32).to(torch.int64) * (1 << 32)
        + (0xFFFFFFFF - pos), -1)
    sel = torch.zeros((tot,), dtype=torch.bool, device=dev)
    sel[torch.topk(rank_key, min(k, tot), sorted=False)[1]] = True
    sel &= live
    evicted_max = torch.where(live & ~sel, csum, 0.0).amax()

    # 4. compact the kept heads to the front, in merged (key) order
    csel = torch.cumsum(sel, 0)
    src = torch.searchsorted(csel, torch.arange(1, k + 1, device=dev)
                             ).clamp_(0, tot - 1)
    valid = torch.arange(k, device=dev) < csel[-1]
    invalid = torch.tensor(INVALID_KEY, device=dev)
    out = Candidates(key_hi=torch.where(valid, m_hi[src], invalid),
                     key_lo=torch.where(valid, m_lo[src], invalid),
                     count=torch.where(valid, csum[src], 0.0),
                     mask=valid)
    return out, evicted_max


def all_gather(cands: Candidates, mesh, axes) -> Candidates:
    """Every rank's candidates along mesh dimension(s) ``axes``, tiled in
    rank order into one (shards·L,) set (the reference's tiled
    ``all_gather``); the mask travels as uint8."""
    return Candidates(*[mesh_mod.all_gather(f, mesh, axes) for f in cands])
