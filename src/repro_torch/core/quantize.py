"""Hypercube quantizer: points -> grid cells -> packed 64-bit keys.

The paper (§III-1) encloses the data in a D-dimensional hypercube with M
linear bins per axis and concatenates the quantized coordinates into one
key.  Each coordinate gets ceil(log2(M)) bits of a 64-bit key carried as
two uint32 limbs (see ``u64``), so D * ceil(log2(M)) <= 64.  Keys are bit
for bit the reference's (``repro.core.quantize``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import u64


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """A fitted quantization grid (corner coords stored as tuples, so the
    spec is hashable and device-free)."""
    dims: int
    bins: int                      # M, linear bins per axis
    lo: Tuple[float, ...]          # (D,) lower corner
    hi: Tuple[float, ...]          # (D,) upper corner
    bits_per_dim: int = 0

    def __post_init__(self):
        object.__setattr__(self, "lo",
                           tuple(float(v) for v in np.asarray(self.lo).ravel()))
        object.__setattr__(self, "hi",
                           tuple(float(v) for v in np.asarray(self.hi).ravel()))
        bits = max(1, math.ceil(math.log2(self.bins)))
        object.__setattr__(self, "bits_per_dim", bits)
        if self.dims * bits > 64:
            raise ValueError(
                f"cannot pack D={self.dims} dims x {bits} bits into 64-bit keys; "
                f"reduce bins (M={self.bins}) or dims (paper regime is D<20)")

    @property
    def lo_arr(self) -> np.ndarray:
        return np.asarray(self.lo, np.float32)

    @property
    def hi_arr(self) -> np.ndarray:
        return np.asarray(self.hi, np.float32)

    @property
    def cell_size(self) -> np.ndarray:
        return (self.hi_arr - self.lo_arr) / self.bins


def fit_grid(points: torch.Tensor, bins: int,
             lo: Optional[np.ndarray] = None,
             hi: Optional[np.ndarray] = None,
             pad: float = 1e-3) -> GridSpec:
    """Fit the enclosing hypercube (one min/max pass on the points'
    device).  ``lo``/``hi`` may be supplied, and then no data pass is made."""
    d = int(points.shape[-1])
    flat = points.reshape(-1, d)
    if lo is None:
        lo = flat.amin(0).cpu().numpy()
    if hi is None:
        hi = flat.amax(0).cpu().numpy()
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    span = np.maximum(hi - lo, 1e-12)
    return GridSpec(dims=d, bins=int(bins), lo=lo - pad * span, hi=hi + pad * span)


def fit_grid_streaming(chunks, bins: int, pad: float = 1e-3) -> GridSpec:
    """Fit the enclosing hypercube from a chunk stream: the first pass of
    the two-pass streaming pipeline.  A running min/max over host chunks,
    so no stage holds the whole array; min and max are exact, so the grid
    equals :func:`fit_grid` on the concatenated points.

    ``chunks``: an iterable of (n_i, D) arrays, or a callable returning
    one (the re-iterable form ``pipeline.run_streaming`` takes)."""
    if callable(chunks):
        chunks = chunks()
    lo = hi = None
    d = None
    for c in chunks:
        c = np.asarray(c, np.float32)
        if c.ndim != 2:
            c = c.reshape(-1, c.shape[-1])
        if d is None:
            d = c.shape[1]
        if c.shape[0] == 0:        # an empty batch: min has no identity
            continue
        clo, chi = c.min(axis=0), c.max(axis=0)
        lo = clo if lo is None else np.minimum(lo, clo)
        hi = chi if hi is None else np.maximum(hi, chi)
    if lo is None:
        raise ValueError("fit_grid_streaming: empty chunk stream")
    span = np.maximum(hi - lo, 1e-12)
    return GridSpec(dims=d, bins=int(bins), lo=lo - pad * span,
                    hi=hi + pad * span)


@functools.lru_cache(maxsize=64)
def _grid_tensors(grid: GridSpec, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.as_tensor(grid.lo_arr, device=device)
    inv = torch.as_tensor(
        np.asarray(grid.bins / (grid.hi_arr - grid.lo_arr), np.float32),
        device=device)
    return lo, inv


def grid_tensors(grid: GridSpec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid's lower corner and bins per unit, (D,) float32 each, as
    :func:`quantize` and the hash_points kernel use them.  Made once per
    (grid, device) and kept (a spec is frozen), so a call on the card
    makes no host copy after the first; callers must not write to them."""
    return _grid_tensors(grid, torch.device(device))


def quantize(grid: GridSpec, points: torch.Tensor) -> torch.Tensor:
    """(..., D) float32 points -> (..., D) int64 bin coordinates in [0, M)."""
    lo, inv = grid_tensors(grid, points.device)
    idx = torch.floor((points - lo) * inv).clamp_(0, grid.bins - 1)
    return idx.to(torch.int64)


def pack(grid: GridSpec, coords: torch.Tensor) -> u64.U64:
    """(..., D) coords -> packed 64-bit keys (hi, lo) of shape (...)."""
    key = (torch.zeros(coords.shape[:-1], dtype=torch.int64,
                       device=coords.device),) * 2
    for i in range(grid.dims):
        key = u64.add_u32(u64.shl(key, grid.bits_per_dim), coords[..., i])
    return key


def unpack(grid: GridSpec, key: u64.U64) -> torch.Tensor:
    """Packed keys (...) -> (..., D) int64 coords (inverse of `pack`)."""
    mask = (1 << grid.bits_per_dim) - 1
    outs = []
    k = key
    for _ in range(grid.dims):
        outs.append(k[1] & mask)
        k = u64.shr(k, grid.bits_per_dim)
    return torch.stack(outs[::-1], dim=-1)


def cell_center(grid: GridSpec, coords: torch.Tensor) -> torch.Tensor:
    """(..., D) coords -> float32 cell centers in data space."""
    cs = torch.as_tensor(grid.cell_size, device=coords.device)
    lo = torch.as_tensor(grid.lo_arr, device=coords.device)
    return lo + (coords.to(torch.float32) + 0.5) * cs


def points_to_keys(grid: GridSpec, points: torch.Tensor) -> u64.U64:
    return pack(grid, quantize(grid, points))


def collision_rate(volume: float, num_hh: int, dims: int
                   ) -> Tuple[float, float]:
    """Paper §III-2 Poisson contact-neighbourhood collision model.

    K heavy hitters on a grid of V cells; each cell's contact neighbourhood
    is the 3^D hypercube around it, so the HH density per neighbourhood is
    rho = K * 3^D / V.  A *random collision* is a neighbourhood containing
    two or more HHs:  P(coll) = P(N>=2) = 1 - e^-rho - rho*e^-rho, and the
    expected number of collided HHs is C = K * P(coll).  This reproduces the
    paper's numbers: K=1e4, D=10, M=8 -> C~1057; M=16 -> C~0.00144.
    """
    rho = 3.0 ** dims * (num_hh / volume)
    p_ge2 = 1.0 - math.exp(-rho) - rho * math.exp(-rho)
    return rho, num_hh * p_ge2


def collision_rate_text(volume: float, num_hh: int, dims: int
                        ) -> Tuple[float, float]:
    """The formula as written in the paper's text: C = K·P(>0) with
    P(>0) = 1 - e^-rho.  The paper's published numbers (1057, 0.00144)
    follow :func:`collision_rate` (P(N>=2)) instead; both are kept."""
    rho = 3.0 ** dims * (num_hh / volume)
    return rho, num_hh * (1.0 - math.exp(-rho))
