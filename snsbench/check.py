"""Whether the window's maps are correct: the program's outputs against
the plain reference (``reference/sns_reference.py``), after the window.

Every map's heavy hitters are compared with the reference's for its
dataset.  The last map is followed stage by stage: its representatives,
a sample of rows of its kNN graph (drawn from the seed), then the
embedder's stages (``stages/<name>.py``), each recomputed by the
reference from the program's own state at that stage's entry.

``control="bf16"`` puts the reference computed in bfloat16 in the
program's place, fed the same inputs at each stage: the reading that a
limit has to stay under."""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

from snsbench import datagen
from snsbench.reference import sns_reference as R

F32 = torch.float32
INF = math.inf


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a − ref| / max |ref|; inf where the shapes differ."""
    if a.shape != ref.shape:
        return INF
    return float((a.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-30))


def hh_mismatch(keys, count, mask, ref: R.HeavyHitters) -> int:
    """Slots of the top-k list whose key, estimate or validity differ."""
    return int(((keys != ref.keys) | (count != ref.count)
                | (mask != ref.mask)).sum())


def knn_numbers(x: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
                dist: torch.Tensor, ref_idx: torch.Tensor,
                ref_dist: torch.Tensor) -> Dict[str, float]:
    """``knn_miss``: the share of the exact neighbours of the sampled rows
    missing from their rows of the graph; ``knn_dist_gap``: the largest
    error of a reported distance against the coordinates', over the
    row's k-th exact distance."""
    if idx.shape != ref_idx.shape:
        return {"knn_miss": INF, "knn_dist_gap": INF}
    hit = (idx[:, :, None] == ref_idx[:, None, :]).any(2).float().mean()
    true = R.pair_dists(x, rows, idx)
    gap = ((dist.float() - true).abs() / ref_dist[:, -1:].clamp(min=1e-30))
    return {"knn_miss": float(1.0 - hit), "knn_dist_gap": float(gap.max())}


def sorted_pairs(src, dst, n):
    return torch.sort(src.long() * n + dst.long())[0]


def judge(cfg: dict, stage, pool: List[torch.Tensor], params: torch.Tensor,
          jitter: torch.Tensor, maps: List[dict], last, got: dict,
          seed: int, control: Optional[str] = None) -> dict:
    """The numbers compared, the maps that failed, and what the reference
    counted on the way (for the rooflines).  ``stage``: the embedder's
    stage module; ``pool``: the points of each dataset; ``maps``: each
    window map's dataset index and heavy hitters; ``last``: the last
    map's result; ``got``: the last map's capture."""
    sns, ck = cfg["sns"], cfg["check"]
    dt = torch.bfloat16 if control == "bf16" else None
    refs = {}
    for m in maps:
        d = m["dataset"]
        if d not in refs:
            refs[d] = R.heavy_hitters(pool[d], sns["bins"], params,
                                      sns["log2_cols"], sns["top_k"], F32)
    d_last = maps[-1]["dataset"]
    grid, hh = refs[d_last]
    num: Dict[str, float] = {}
    failed = set()
    if dt is None:
        for i, m in enumerate(maps):
            bad = hh_mismatch(m["keys"], m["count"], m["mask"],
                              refs[m["dataset"]][1])
            num["hh_mismatch"] = max(num.get("hh_mismatch", 0), bad)
            if bad:
                failed.add(i)
    else:
        _, hc = R.heavy_hitters(pool[d_last], sns["bins"], params,
                                sns["log2_cols"], sns["top_k"], dt)
        num["hh_mismatch"] = hh_mismatch(hc.keys, hc.count, hc.mask, hh)

    reps = R.representatives(grid, hh, jitter, sns["max_replicas"], F32)
    cand = last.reps if dt is None else R.representatives(
        grid, hh, jitter, sns["max_replicas"], dt)
    if not torch.equal(cand.mask, reps.mask):
        num["rep_gap"] = INF
    else:
        cell = torch.as_tensor(grid.cell, device=reps.points.device)
        live = reps.mask
        dp = ((cand.points[live] - reps.points[live]).abs() / cell).max()
        dw = rel(cand.weight[live], reps.weight[live])
        num["rep_gap"] = max(float(dp), dw)
    x, w = reps.points[reps.mask], reps.weight[reps.mask]
    n = x.shape[0]

    k = stage.knn_k(cfg, n)
    g = datagen.generator(seed, 3, x.device)
    rows = torch.randperm(n, generator=g, device=x.device)[
        :min(ck["sample_rows"], n)]
    ref_idx, ref_dist = R.knn_rows(x, rows, k, F32)
    idx_p, dist_p = got["knn"]
    if idx_p.shape[0] != n:
        num.update(knn_miss=INF, knn_dist_gap=INF)
    elif dt is None:
        num.update(knn_numbers(x, rows, idx_p[rows], dist_p[rows],
                               ref_idx, ref_dist))
    else:
        num.update(knn_numbers(x, rows, *R.knn_rows(x, rows, k, dt),
                               ref_idx, ref_dist))

    try:
        if idx_p.shape[0] != n:
            raise ValueError(f"the graph has {idx_p.shape[0]} rows, the "
                             f"reference's representatives {n}")
        num.update(stage.numbers(cfg, got, last, idx_p, dist_p, w, dt))
    except Exception as exc:            # a stage that cannot be followed
        print(f"check: {stage.__name__} stages not followed: {exc!r}",
              file=sys.stderr)
        num.update({k: INF for k in stage.NUMBERS})
    counts = {d: {"cells": r.cells, "table_cells": r.table_cells,
                  "pool_cells": r.pool_cells,
                  "queries": min(2 * sns["top_k"], pool[d].shape[0])}
              for d, (_, r) in refs.items()}
    return {"numbers": num, "failed_maps": failed, "counts": counts}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN is over)."""
    return all(numbers.get(k, INF) <= v for k, v in limits.items()) and \
        all(k in limits for k in numbers)
