"""Driver ``resident``: the whole data set on one card, every map one call
of ``pipeline.run(cfg, points)`` on it.

A driver provides ``CHIPS`` (the cards it maps on) and ``set_up(cfg,
traffic, seed, dev, stage)``, which makes the mix's inputs from the seed,
warms up the cell's own shapes and returns a site: an object with
``run_map(d)`` (one map of dataset ``d``, returning the program's
``SnsResult``), ``datasets`` (how many the pool holds), ``dataset(d)``
(the points the reference judges map ``d`` by), and ``params`` and
``jitter`` (the draws the program was handed).  The harness's window
calls ``run_map`` back to back; a driver whose window differs may
provide its own ``window_loop`` with the harness's signature."""
from __future__ import annotations

import sys
import time

import torch

from snsbench import datagen, program

CHIPS = 1


class Site:
    def __init__(self, dev, pool, params, jitter, draws, args):
        self.dev, self.pool = dev, pool
        self.params, self.jitter = params, jitter
        self._draws, self._args = draws, args

    @property
    def datasets(self) -> int:
        return len(self.pool)

    def dataset(self, d: int) -> torch.Tensor:
        return self.pool[d]

    def run_map(self, d: int, args=None):
        from repro_torch.core import pipeline
        return pipeline.run(points=self.pool[d], device=self.dev,
                            draws=self._draws, **(args or self._args))


def set_up(cfg: dict, traffic: dict, seed: int, dev: torch.device,
           stage) -> Site:
    """The pool of ``traffic["pool"]`` datasets on the card, the draws,
    and one warm-up map (cut as the configuration's ``warmup`` says)."""
    times = [time.perf_counter()]
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()          # every kernel at once; cached after
    times.append(time.perf_counter())
    pool = [datagen.mixture(cfg["data"], seed, i, dev)
            for i in range(traffic["pool"])]
    params, jitter, draws = program.draws(cfg, seed, dev)
    site = Site(dev, pool, params, jitter, draws, program.args(cfg, seed))
    times.append(time.perf_counter())
    site.run_map(0, program.warmup_args(cfg, seed))
    stage.warm_up(cfg, dev)
    program.sync(dev)
    times.append(time.perf_counter())
    print("set-up (s): kernels {:.2f}, data and draws {:.2f}, warm-up "
          "{:.2f}".format(*[b - a for a, b in zip(times, times[1:])]),
          file=sys.stderr)
    return site
