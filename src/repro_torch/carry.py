"""Carry the reference's random draws across.

This system has no weights: its "parameters" are the random draws the
reference makes with JAX's threefry — hash parameters, cell-keyed replica
jitter, the tSNE and UMAP inits and UMAP's per-epoch negative samples.  The port draws its own
from ``torch.Generator``s and does not reproduce threefry; where a test
holds the port to the reference bit for bit, it makes the reference's
draws with JAX, hands them over as numpy, and these functions turn them
into the port's types.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import u64
from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.pipeline import Draws


def hash_params_from_numpy(a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo,
                           device="cpu") -> MulShiftParams:
    """Six (R,) uint32 arrays (the reference's ``MulShiftParams`` fields,
    in order) -> the port's int64-limb params on ``device``."""
    return MulShiftParams(*[u64.from_numpy(p).to(device) for p in
                            (a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo)])


def draws_from_numpy(hash_params=None, jitter: Optional[np.ndarray] = None,
                     umap_init: Optional[np.ndarray] = None,
                     negatives: Optional[np.ndarray] = None,
                     tsne_init: Optional[np.ndarray] = None,
                     device="cpu") -> Draws:
    """Build :class:`pipeline.Draws` from numpy: ``hash_params`` as six
    uint32 arrays, ``jitter`` (K, max_replicas, D), ``umap_init`` and
    ``tsne_init`` (N_reps, dims), ``negatives`` (n_epochs, E, neg_rate)."""
    def f32(x):
        return None if x is None else torch.as_tensor(
            np.array(x, np.float32), device=device)
    return Draws(
        hash_params=None if hash_params is None
        else hash_params_from_numpy(*hash_params, device=device),
        jitter=f32(jitter), umap_init=f32(umap_init),
        negatives=None if negatives is None else torch.as_tensor(
            np.array(negatives, np.int64), device=device),
        tsne_init=f32(tsne_init))
