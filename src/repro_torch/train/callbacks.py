"""Training callbacks, including the paper's pipeline as a live monitor
(the port of ``repro.train.callbacks``).

``ActivationSketcher`` runs Sketch-and-Scale over the model's hidden
states during training: a batch of residual-stream vectors is
normalised, randomly projected to ``proj_dims`` ≤ 8 dims, quantized on
a fixed grid and streamed into a Count Sketch (K7 on the card, one
launch an observe).  At report time the heavy hitters — the densest
cells of representation space over every token seen — come out of the
sketch (K8, one launch a report).  The sketch is linear, so workers'
sketches merge by addition: :meth:`ActivationSketcher.merged` adds
another worker's, or every rank's of a mesh (an all-reduce of the
table).  For MoE models the same machinery over
router logits detects routing collapse.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import hashing, prng
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import quantize, sketch as sketch_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.quantize import GridSpec

RESERVOIR_KEYS = 4096       # candidate keys kept an observe
RESERVOIR_BATCHES = 64      # observes whose keys are kept


@dataclasses.dataclass
class ActivationSketcher:
    proj_dims: int = 8
    bins: int = 16
    rows: int = 8
    log2_cols: int = 14
    top_k: int = 256
    seed: int = 0
    box: float = 4.0            # grid half-width in projected units
    device: Any = None          # the card unless the caller names another

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._sk = sketch_mod.init(
            hashing.make_params(prng.key(self.seed, self.device), self.rows),
            self.log2_cols)
        self._proj: Optional[torch.Tensor] = None
        self._grid = GridSpec(
            dims=self.proj_dims, bins=self.bins,
            lo=tuple([-self.box] * self.proj_dims),
            hi=tuple([self.box] * self.proj_dims))
        self._keys: List[torch.Tensor] = []
        self.tokens_seen = 0

    @torch.no_grad()
    def observe(self, acts: torch.Tensor) -> None:
        """acts: (..., d_model) hidden states from the current step."""
        d = acts.shape[-1]
        if self._proj is None:
            self._proj = (prng.normal(prng.key(self.seed + 1), (d,
                                      self.proj_dims)) / math.sqrt(d)
                          ).to(self.device)
        flat = acts.reshape(-1, d).to(self.device, torch.float32)
        # normalize scale so the fixed grid stays meaningful
        norm = torch.sqrt(torch.sum(flat * flat, dim=1, keepdim=True))
        flat = flat / (norm / math.sqrt(d) + 1e-6)
        khi, klo = quantize.points_to_keys(self._grid, flat @ self._proj)
        self._sk = sketch_mod.update_sorted(self._sk, khi, klo)
        # a bounded reservoir of keys as heavy-hitter candidates
        take = min(khi.shape[0], RESERVOIR_KEYS)
        self._keys.append(torch.stack([khi[:take], klo[:take]], 1))
        self._keys = self._keys[-RESERVOIR_BATCHES:]
        self.tokens_seen += math.prod(acts.shape[:-1])

    def report(self) -> Dict[str, Any]:
        """Heavy hitters of representation space."""
        if not self._keys:
            return {"hh_count": 0}
        keys = torch.cat(self._keys)
        hh = hh_mod.extract(self._sk, keys[:, 0].contiguous(),
                            keys[:, 1].contiguous(), k=self.top_k)
        counts = hh.count[hh.mask]
        total = float(counts.sum())
        return {
            "hh_count": int(hh.mask.sum()),
            "hh_mass": total,
            "hh_top1_frac": float(counts[0]) / total if total else 0.0,
            "hh": hh,
            "grid": self._grid,
            "tokens_seen": self.tokens_seen,
        }

    def merged(self, other: Optional["ActivationSketcher"] = None, *,
               mesh=None, axes=None) -> sketch_mod.CountSketch:
        """Cross-worker merge (linearity): local sketches simply add —
        ``other``'s, or every rank's over the ``mesh`` dimensions ``axes``
        (innermost first; an all-reduce of the table, whose integer counts
        add to the same bits in any order)."""
        if other is not None:
            return sketch_mod.merge(self._sk, other._sk)
        if mesh is None or not axes:
            raise ValueError("merged() needs another sketcher or a mesh and "
                             "its axes")
        return sketch_mod.psum_merge(self._sk, mesh, axes)


@dataclasses.dataclass
class RouterCollapseMonitor:
    """HH concentration over router logits: a routing-collapse alarm."""
    sketcher: Optional[ActivationSketcher] = None
    alarm_top1_frac: float = 0.5
    device: Any = None

    def __post_init__(self):
        if self.sketcher is None:
            self.sketcher = ActivationSketcher(proj_dims=4, bins=12,
                                               top_k=64, seed=17,
                                               device=self.device)

    def observe(self, router_logits: torch.Tensor) -> None:
        self.sketcher.observe(router_logits)

    def check(self) -> Dict[str, Any]:
        rep = self.sketcher.report()
        rep["collapsed"] = rep.get("hh_top1_frac", 0.0) > self.alarm_top1_frac
        return rep
