"""Heavy hitters → weighted representative points for the embedder.

Paper §II-1: each HH cell is replicated with a small uniform jitter (a
quarter of the cell size).  Three replica schemes:

* ``"uniform"`` — max_replicas replicas per HH;
* ``"rank"``    — 1 + ⌊log₂(r_max / r)⌋ replicas for rank r;
* ``"count"``   — 1 + ⌊log₂(f / f_min)⌋ replicas for count f.

Static shapes: K·max_replicas slots, slot (i, j) live iff j < n_i.  The
jitter is keyed by cell, not by HH row, as in the reference: cell
(hi, lo) draws ``uniform(fold_in(fold_in(key, hi), lo))`` with the
threefry of ``core.prng``, bit for bit the reference's draw, so a
reshuffled ranking leaves every cell's points where they were.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng, quantize
from repro_torch.core.heavy_hitters import HeavyHitters
from repro_torch.core.quantize import GridSpec


class Representatives(NamedTuple):
    points: torch.Tensor    # (slots, D) float32 jittered cell centers
    weight: torch.Tensor    # (slots,) float32 HH count carried by the point
    hh_id: torch.Tensor     # (slots,) int64 HH the point came from
    mask: torch.Tensor      # (slots,) bool


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``'s arithmetic, log(x) / log(2) in float32, so floor()
    of it lands on the same integer at exact powers of two."""
    return torch.log(x) / torch.log(torch.tensor(2.0, device=x.device))


def replica_counts(hh: HeavyHitters, scheme: str, max_replicas: int
                   ) -> torch.Tensor:
    """(K,) int64 number of replicas per HH under the paper's schemes."""
    k = hh.count.shape[0]
    dev = hh.count.device
    if scheme == "uniform":
        n = torch.full((k,), max_replicas, dtype=torch.int64, device=dev)
    elif scheme == "rank":
        # 1-based ranks in count-descending order; hh is already sorted
        r = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
        r_max = hh.mask.to(torch.float32).sum()
        n = 1 + torch.floor(_log2((r_max / r).clamp(min=1.0))).to(torch.int64)
    elif scheme == "count":
        f = hh.count.clamp(min=1e-9)
        f_min = torch.where(hh.mask, f, float("inf")).min()
        n = 1 + torch.floor(_log2((f / f_min).clamp(min=1.0))).to(torch.int64)
    else:
        raise ValueError(f"unknown replica scheme {scheme!r}")
    return torch.where(hh.mask, n.clamp(1, max_replicas), 0)


def make_representatives(grid: GridSpec, hh: HeavyHitters,
                         scheme: str = "count", max_replicas: int = 8,
                         jitter_frac: float = 0.25, *,
                         key: Optional[prng.Key] = None,
                         jitter: Optional[torch.Tensor] = None
                         ) -> Representatives:
    """HH cells → jittered weighted points.

    ``jitter`` is an optional (K, max_replicas, D) array of offsets in
    cell units, uniform in [-jitter_frac, jitter_frac]; without it each
    cell draws its own from the threefry ``key`` (``core.prng``, on the
    HH tensors' device)."""
    k = hh.key_hi.shape[0]
    dev = hh.key_hi.device
    coords = quantize.unpack(grid, (hh.key_hi, hh.key_lo))    # (K, D)
    centers = quantize.cell_center(grid, coords)              # (K, D)
    n = replica_counts(hh, scheme, max_replicas)              # (K,)
    cell = torch.as_tensor(grid.cell_size, device=dev)        # (D,)
    if jitter is None:
        if key is None:
            raise ValueError("make_representatives needs a threefry key "
                             "or the jitter")
        cell_key = prng.fold_in(prng.fold_in(key, hh.key_hi), hh.key_lo)
        jitter = prng.uniform(cell_key, (max_replicas, grid.dims),
                              -jitter_frac, jitter_frac)
    else:
        jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev)
        if jitter.shape != (k, max_replicas, grid.dims):
            raise ValueError(f"jitter must have shape "
                             f"{(k, max_replicas, grid.dims)}, "
                             f"got {tuple(jitter.shape)}")
    pts = centers[:, None, :] + jitter * cell[None, None, :]  # (K, max, D)
    live = torch.arange(max_replicas, device=dev)[None, :] < n[:, None]
    # each replica carries count / n, so the total mass is preserved
    w = hh.count[:, None] / n[:, None].to(torch.float32).clamp(min=1.0)
    hh_id = torch.arange(k, device=dev)[:, None].expand(k, max_replicas)
    return Representatives(
        points=pts.reshape(k * max_replicas, grid.dims),
        weight=torch.where(live, w, 0.0).reshape(-1),
        hh_id=hh_id.reshape(-1),
        mask=live.reshape(-1))


def compact(rep: Representatives
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop masked slots -> (points, weights, hh_ids), on the reps' device."""
    m = rep.mask
    return rep.points[m], rep.weight[m], rep.hh_id[m]
