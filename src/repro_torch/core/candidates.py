"""Candidate tracking: sorted key runs and the exact local top-k.

The Count Sketch estimates frequencies but stores no key identities, so
each shard extracts its exact top-L keys next to the sketch and the heavy
hitter stage re-estimates them on the sketch.  The currency is
:class:`KeyRuns`, the output of ONE sort + run-length encoding over the
keys (:func:`sorted_runs`); the same runs feed the sketch scatter
(``sketch.update_runs``) and the candidate top-k (:func:`topk_from_runs`).

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

from repro_torch.core import u64

INVALID_KEY = 0xFFFFFFFF


class Candidates(NamedTuple):
    """Top-L locally frequent keys of one shard (padded, mask-carrying),
    count-descending."""
    key_hi: torch.Tensor    # (L,) int64 holding uint32
    key_lo: torch.Tensor    # (L,) int64 holding uint32
    count: torch.Tensor     # (L,) float32, exact local count
    mask: torch.Tensor      # (L,) bool, False for padding


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
    """``lax.top_k(score, k)`` on a float32 vector: the k largest in total
    order, lower index first among ties."""
    idx = torch.sort(total_order(score), descending=True, stable=True)[1][:k]
    return score[idx], idx


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
