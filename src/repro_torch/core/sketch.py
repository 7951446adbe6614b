"""Count Sketch (Charikar-Chen-Farach-Colton) on tensors.

The paper's operations (§III-1): init / update / estimate.  The table is
a linear operator over the frequency vector, so two sketches built with
the same hashes merge by addition.

The scatter is ``index_add_`` on the flattened (R·C) table: atomic on the
card, and exact for integer counts below 2**24, where every order of
addition gives the same bits, so tables match the reference's bit for bit.
Hashes are computed in chunks of items, which bounds the (R, items)
int64 temporaries at full scale.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import hashing, u64
from repro_torch.core.candidates import INVALID_KEY, KeyRuns, topk_desc

# items hashed per pass: (R=16, 2**21) int64 temporaries are 256 MiB each
_HASH_CHUNK = 1 << 21


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
    v = torch.ones_like(key_hi, dtype=sk.table.dtype) if values is None \
        else values.to(sk.table.dtype)
    if mask is not None:
        v = v * mask.to(sk.table.dtype)
    flat = sk.table.reshape(-1).clone()
    row_base = (torch.arange(sk.rows, device=flat.device)
                << sk.log2_cols)[:, None]
    for s in range(0, key_hi.shape[0], _HASH_CHUNK):
        sl = slice(s, s + _HASH_CHUNK)
        buckets, signs = hashing.hashes(sk.params, key_hi[sl], key_lo[sl],
                                        sk.log2_cols)
        flat.index_add_(0, (row_base | buckets).reshape(-1),
                        (signs.to(flat.dtype) * v[sl][None, :]).reshape(-1))
    return sk._replace(table=flat.reshape(sk.table.shape))


def update_runs(sk: CountSketch, runs: KeyRuns) -> CountSketch:
    """Scatter pre-deduped sorted key runs.  Only live runs are hashed:
    dead slots carry count 0 and scatter nothing in the reference either."""
    live = runs.live.nonzero().squeeze(1)
    return update(sk, runs.key_hi[live], runs.key_lo[live],
                  values=runs.count[live])


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: sort, then the mean of the two middle
    values, as (low + high) * 0.5 (``torch.median`` returns the lower)."""
    s = torch.sort(x, dim=0)[0]
    r = x.shape[0]
    return (s[(r - 1) // 2] + s[r // 2]) * 0.5


def estimate(sk: CountSketch, key_hi: torch.Tensor, key_lo: torch.Tensor
             ) -> torch.Tensor:
    """Median over rows of h2_r(i)·S[r, h1_r(i)].  (items,) float32."""
    buckets, signs = hashing.hashes(sk.params, key_hi, key_lo, sk.log2_cols)
    gathered = torch.gather(sk.table, 1, buckets)
    return median_rows(gathered.to(torch.float32) * signs.to(torch.float32))


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
