"""Stages ``umap``: UMAP's fuzzy set, epochs and last step, captured from
the program and checked against the plain reference.

A stage module provides ``NUMBERS`` (the names it compares, each with a
limit under the configuration's ``check.limits``), ``knn_k(cfg, n)`` (the
graph's neighbours at ``n`` representatives), ``install(cap)`` (the
captures, through ``Capture.wrap``), ``warm_up(cfg, dev)`` (shapes the
warm-up map does not reach) and ``numbers(cfg, got, last, idx, dist, w,
dt)``: each number from the program's state at the stage's entry (``got``
the last map's capture, ``last`` its result, the graph and the
representatives' weights), or from the reference computed in ``dt`` put
in the program's place where ``dt`` is not None (the control).

Captured: ``fuzzy``, the symmetrized memberships (edges, values);
``epoch_first``/``epoch_last``, the first and last epochs' positions,
edge layout, normalized memberships, negatives and the move computed."""
from __future__ import annotations

from typing import Dict

import torch

from snsbench.check import F32, INF, rel, sorted_pairs
from snsbench.reference import sns_reference as R

NUMBERS = ("fuzzy_gap", "epoch_gap", "update_gap")


def knn_k(cfg: dict, n: int) -> int:
    return min(cfg["umap"]["n_neighbors"], n - 1)


def install(cap) -> None:
    from repro_torch.core import umap

    def fuzzy(out, *a, **k):
        cap.got["fuzzy"] = out

    def epoch(out, y, layout, memb_n, neg, a, b):
        cap.first_last("epoch", dict(y=y, src=layout.src, dst=layout.dst,
                                     memb_n=memb_n, neg=neg, a=a, b=b,
                                     out=out))

    cap.wrap(umap, "fuzzy_simplicial_set", fuzzy)
    cap.wrap(umap, "epoch_delta", epoch)
    cap.wrap(umap, "optimize_embedding")


def warm_up(cfg: dict, dev) -> None:
    """The warm-up map reaches every shape of a UMAP map."""


def numbers(cfg, got, last, idx, dist, w, dt) -> Dict[str, float]:
    u = cfg["umap"]
    n, k = idx.shape
    memb = R.fuzzy_set(idx, dist, w, u["sigma_search_iters"], F32)
    edges, memb_p = got["fuzzy"]
    ef, el = got["epoch_first"], got["epoch_last"]
    if dt is not None:
        memb_p = R.fuzzy_set(idx, dist, w, u["sigma_search_iters"], dt)
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    same_edges = (torch.equal(edges[:, 0], rows)
                  and torch.equal(edges[:, 1], idx.reshape(-1))
                  and torch.equal(sorted_pairs(ef["src"], ef["dst"], n),
                                  sorted_pairs(rows, idx.reshape(-1), n)))
    memb_n = torch.sort(memb / memb.max())[0]
    got_n = torch.sort(memb_p / memb_p.max())[0] if dt is not None \
        else torch.sort(ef["memb_n"])[0]
    fuzzy = max(float((memb_p - memb).abs().max()),
                float((got_n - memb_n).abs().max())) if same_edges else INF
    a, b = R.umap_ab(u["spread"], u["min_dist"])
    gaps = [abs(ef["a"] - a) / a, abs(ef["b"] - b) / b]
    for e in (ef, el):
        ref = R.umap_epoch(e["y"], e["src"], e["dst"], e["memb_n"], e["neg"],
                           a, b, F32)
        out = e["out"] if dt is None else R.umap_epoch(
            e["y"], e["src"], e["dst"], e["memb_n"], e["neg"], a, b, dt)
        gaps.append(rel(out, ref))
    alpha = R.umap_alpha(u["learning_rate"], u["n_epochs"] - 1, u["n_epochs"])
    y_ref = el["y"] + alpha * el["out"]
    y_got = last.embedding if dt is None else R.rnd(
        R.rnd(el["y"], dt) + R.rnd(alpha * el["out"], dt), dt)
    return {"fuzzy_gap": fuzzy, "epoch_gap": max(gaps),
            "update_gap": rel(y_got, y_ref)}
