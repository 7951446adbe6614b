"""Faults planted in the program's timed path, by name: the check has to
find each of them (``snsbench/tests``).  :func:`plant` replaces a module
attribute of the program for the rest of the process."""
from __future__ import annotations

import torch


def unchanged_state() -> None:
    """Every optimizer step returns its state unchanged."""
    from repro_torch.core import tsne, umap
    tsne._momentum_update = lambda st, grad, mom, cfg: st
    umap.epoch_delta = lambda y, *a: torch.zeros_like(y)


def half_batch() -> None:
    """Each map sketches only the first half of its points."""
    from repro_torch.core import pipeline
    orig = pipeline._points_tensor
    pipeline._points_tensor = lambda p, d: orig(p[:p.shape[0] // 2], d)


def answer_altered() -> None:
    """One heavy hitter's estimate is off by one where it is produced."""
    from repro_torch.core import heavy_hitters
    orig = heavy_hitters.from_candidates

    def altered(*a, **k):
        hh = orig(*a, **k)
        count = hh.count.clone()
        count[7] += 1.0
        return hh._replace(count=count)
    heavy_hitters.from_candidates = altered


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch,
                                  answer_altered)}


def plant(name) -> None:
    if name:
        FAULTS[name]()
