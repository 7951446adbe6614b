"""Synthetic data: clustered point clouds matching the paper's data
statistics (dense clusters + uniform background), the stand-in for the
cancer-pixel and SDSS-star sets.  numpy only, so the same seed gives the
reference's points (``repro.data.synthetic``) exactly.

* ``gaussian_mixture`` — one cloud with ground-truth labels;
* ``clustered_points_sharded`` — shard w's own slice of the same mixture
  from its own seed: no host ever holds the global array (the paper's
  geo-distributed setting)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MixtureSpec:
    dims: int = 8
    n_clusters: int = 10
    cluster_std: float = 0.02
    background_frac: float = 0.3
    box_lo: float = 0.0
    box_hi: float = 1.0

    def centers(self, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.uniform(self.box_lo + 0.1, self.box_hi - 0.1,
                           size=(self.n_clusters, self.dims))


def gaussian_mixture(n: int, spec: MixtureSpec = MixtureSpec(),
                     seed: int = 0, shuffle: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (points (N, D) f32 in the box, labels (N,) int: -1=background)."""
    rng = np.random.default_rng(seed + 1)
    centers = spec.centers(seed)
    n_bg = int(n * spec.background_frac)
    n_cl = n - n_bg
    per = n_cl // spec.n_clusters
    pts = [rng.uniform(spec.box_lo, spec.box_hi, size=(n_bg, spec.dims))]
    labels = [np.full((n_bg,), -1, np.int32)]
    for i, c in enumerate(centers):
        m = per if i < spec.n_clusters - 1 else n_cl - per * (spec.n_clusters - 1)
        pts.append(c + spec.cluster_std * rng.normal(size=(m, spec.dims)))
        labels.append(np.full((m,), i, np.int32))
    pts = np.clip(np.concatenate(pts), spec.box_lo, spec.box_hi)
    labels = np.concatenate(labels)
    if shuffle:
        perm = rng.permutation(n)
        pts, labels = pts[perm], labels[perm]
    return pts.astype(np.float32), labels


def clustered_points_sharded(shard: int, n_per_shard: int,
                             spec: MixtureSpec = MixtureSpec(),
                             seed: int = 0) -> np.ndarray:
    """Shard-local generation: the same mixture, disjoint randomness.
    Every site draws from the identical cluster model (the paper's
    assumption: one underlying distribution, geographically split)."""
    pts, _ = gaussian_mixture(n_per_shard, spec,
                              seed=seed * 100_003 + shard * 7 + 13)
    return pts
