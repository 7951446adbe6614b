"""Stages ``tsne_sparse``: sparse tSNE's joint P, gradients and momentum
step, captured from the program and checked against the plain reference
(what a stage module provides: ``umap.py``).

Captured: ``p``, the joint P; ``grad_first``/``grad_last``, the first and
last gradients (positions, exaggeration, grid size, gradient);
``update``, the last momentum step (state in, gradient).  The
iterations between the first and the last are not followed."""
from __future__ import annotations

from typing import Dict

import torch

from snsbench.check import F32, INF, rel
from snsbench.reference import sns_reference as R

NUMBERS = ("p_gap", "grad_gap", "update_gap")


def knn_k(cfg: dict, n: int) -> int:
    t = cfg["tsne"]
    return min(cfg["sns"].get("embed_knn") or max(8, round(3 * t["perplexity"])),
               n - 1)


def install(cap) -> None:
    from repro_torch.core import tsne

    def p(out, *a, **k):
        cap.got["p"] = out

    def grad(out, y, sp, exaggeration=1.0, grid_size=128):
        cap.first_last("grad", dict(y=y, exag=exaggeration, g=grid_size,
                                    grad=out[0]))

    def update(out, state, grad, mom, cfg):
        cap.got["update"] = dict(y=state.y, vel=state.velocity,
                                 gains=state.gains, grad=grad)

    cap.wrap(tsne, "sparse_p_from_knn", p)
    cap.wrap(tsne, "sparse_grad", grad)
    cap.wrap(tsne, "_momentum_update", update)
    cap.wrap(tsne, "_optimize")


def warm_up(cfg: dict, dev) -> None:
    """cuFFT's plans for the particle-mesh grids a map may grow to (the
    configuration's ``warmup.fft_grids``): the (3, 2G, 2G) and (2G, 2G)
    real transforms and their inverses."""
    for g in cfg.get("warmup", {}).get("fft_grids", ()):
        for shape in ((3, 2 * g, 2 * g), (2 * g, 2 * g)):
            f = torch.fft.rfft2(torch.zeros(shape, device=dev))
            torch.fft.irfft2(f, s=(2 * g, 2 * g))


def numbers(cfg, got, last, idx, dist, w, dt) -> Dict[str, float]:
    t = cfg["tsne"]
    p = R.sparse_p(idx, dist, w, t["perplexity"], t["sigma_search_iters"], F32)
    pp = got["p"] if dt is None else R.sparse_p(
        idx, dist, w, t["perplexity"], t["sigma_search_iters"], dt)
    if torch.equal(pp.src, p.src) and torch.equal(pp.dst, p.dst):
        p_gap = rel(pp.val, p.val)
    else:
        p_gap = INF
    gaps = []
    schedule = {"grad_first": t["early_exaggeration"]
                if t["exaggeration_iters"] > 0 else 1.0,
                "grad_last": t["early_exaggeration"]
                if t["n_iter"] - 1 < t["exaggeration_iters"] else 1.0}
    for key, exag in schedule.items():
        e = got[key]
        ref = R.tsne_grad(e["y"], p, exag, e["g"], F32)
        out = e["grad"] if dt is None else R.tsne_grad(e["y"], p, exag,
                                                       e["g"], dt)
        gaps.append(rel(out, ref) if e["exag"] == exag else INF)
    return {"p_gap": p_gap, "grad_gap": max(gaps),
            "update_gap": update_gap(t, got["update"], last, dt)}


def update_gap(t, u, last, dt) -> float:
    """The last momentum step's map (the program's returned embedding)
    against the reference's from the same state and gradient."""
    mom = t["momentum_start"] if t["n_iter"] - 1 < t["momentum_switch"] \
        else t["momentum_final"]
    step = dict(mom=mom, lr=t["learning_rate"], min_gain=t["min_gain"])
    ref = R.tsne_update(u["y"], u["vel"], u["gains"], u["grad"], dt=F32,
                        **step)
    out = last.embedding if dt is None else R.tsne_update(
        u["y"], u["vel"], u["gains"], u["grad"], dt=dt, **step)
    return rel(out, ref)
