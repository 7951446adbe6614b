"""Synthetic data: clustered point clouds matching the paper's data
statistics (dense clusters + uniform background), the stand-in for the
cancer-pixel and SDSS-star sets, and LM token batches.  The same seed
gives the reference's data (``repro.data.synthetic``) exactly.

* ``gaussian_mixture`` — one cloud with ground-truth labels (numpy);
* ``clustered_points_sharded`` — shard w's own slice of the same mixture
  from its own seed: no host ever holds the global array (the paper's
  geo-distributed setting);
* ``zipf_token_stream`` — LM batches with zipfian unigram statistics,
  drawn with the reference's threefry (``core.prng``)."""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import prng


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


# XLA:CPU's reduction and scan orders for a float32 vector (the reference
# computes the zipf table with them): a sum reduces windows of 32 after
# centring the zero padding, until 32 or fewer values are left; a cumsum
# scans rows of 16 and adds the scanned row totals (XLA's reduce-window
# rewrite of ``jnp.cumsum``).
_SUM_WINDOW = 32
_SCAN_ROW = 16


def _xla_sum_f32(x: np.ndarray) -> np.float32:
    while x.shape[0] > _SUM_WINDOW:
        n = x.shape[0]
        pad = -(-n // _SUM_WINDOW) * _SUM_WINDOW - n
        x = np.concatenate([np.zeros(pad // 2, np.float32), x,
                            np.zeros(pad - pad // 2, np.float32)])
        x = _seq_sum_rows(x.reshape(-1, _SUM_WINDOW))
    return _seq_sum_rows(x[None, :])[0]


def _seq_sum_rows(x: np.ndarray) -> np.ndarray:
    """Each row summed left to right in float32."""
    acc = np.zeros(x.shape[0], np.float32)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _xla_cumsum_f32(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    if n <= _SCAN_ROW:
        return np.cumsum(x, dtype=np.float32)
    rows = -(-n // _SCAN_ROW)
    xp = np.concatenate([x, np.zeros(rows * _SCAN_ROW - n, np.float32)])
    scanned = np.cumsum(xp.reshape(rows, _SCAN_ROW), axis=1,
                        dtype=np.float32)
    before = np.concatenate([np.zeros(1, np.float32),
                             _xla_cumsum_f32(scanned[:, -1].copy())[:-1]])
    return (scanned + before[:, None]).reshape(-1)[:n]


@functools.lru_cache(maxsize=8)
def zipf_cdf(vocab: int, alpha: float) -> np.ndarray:
    """The reference's cumulative zipf table (read-only float32, (vocab,)):
    ``cumsum(p)`` of ``p = q / sum(q)``, ``q = 1 / rank**alpha``, with
    XLA:CPU's float32 roundings: ``pow`` is the C library's ``powf``
    (XLA:CPU calls it), the sum and the cumsum in XLA's orders."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    powf = libm.powf
    powf.restype, powf.argtypes = ctypes.c_float, [ctypes.c_float] * 2
    a = float(np.float32(alpha))
    q = np.float32(1.0) / np.array([powf(float(r), a)
                                    for r in range(1, vocab + 1)], np.float32)
    cdf = _xla_cumsum_f32(q / _xla_sum_f32(q))
    cdf.setflags(write=False)
    return cdf


def zipf_token_stream(key: prng.Key, batch: int, seq: int, vocab: int,
                      alpha: float = 1.2) -> Dict[str, torch.Tensor]:
    """LM batch with zipfian tokens and shifted labels on the key's device:
    ``tokens`` and ``labels`` (B, seq) int64, ``loss_mask`` ones.  The
    reference's ``jax.random.choice(key, vocab, (B, seq + 1), p=probs)``
    bit for bit: ``r = cdf[-1]·(1 − uniform(key))``, then the first rank
    whose cumulative probability reaches r."""
    dev = key[0].device
    cdf = torch.tensor(zipf_cdf(vocab, alpha), device=dev)
    r = cdf[-1] * (1.0 - prng.uniform(key, (batch, seq + 1)))
    toks = torch.searchsorted(cdf, r.reshape(-1)).reshape(batch, seq + 1)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous(),
            "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                    device=dev)}
