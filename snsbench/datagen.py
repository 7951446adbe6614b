"""The benchmark's inputs, made on the device from ``--seed``.

The points are the paper's stand-in for its cancer pixels: a mixture of
Gaussian blobs over a uniform background in a box (the port's
``data.synthetic.MixtureSpec``, drawn here with torch on the device in a
few large calls).  The hash parameters and the replica jitter are drawn
here too and handed to the program, so that the reference can recompute
the sketch and the representatives from the same inputs.
"""
from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for the stream ``stream`` of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7_919 * stream) & SEED_MASK)
    return g


def mixture(data: dict, seed: int, index: int, device) -> torch.Tensor:
    """Dataset ``index`` of the pool: (points, dims) float32 in the box.
    ``background_frac`` of the points uniform in the box, the rest split
    evenly over ``clusters`` Gaussian blobs of std ``cluster_std`` whose
    centres are uniform in the box less 0.1 a side; clipped to the box,
    then shuffled."""
    g = generator(seed, 100 + index, device)
    n, d = int(data["points"]), int(data["dims"])
    lo, hi = (float(v) for v in data["box"])
    k = int(data["clusters"])
    centers = lo + 0.1 + (hi - lo - 0.2) * torch.rand(
        (k, d), generator=g, device=device)
    n_bg = int(n * float(data["background_frac"]))
    n_cl = n - n_bg
    pts = torch.empty((n, d), device=device)
    pts[:n_bg].uniform_(lo, hi, generator=g)
    blob = torch.div(torch.arange(n_cl, device=device) * k, n_cl,
                     rounding_mode="floor")
    body = pts[n_bg:]
    body.normal_(0.0, float(data["cluster_std"]), generator=g)
    body += centers[blob]
    pts.clamp_(lo, hi)
    return pts[torch.randperm(n, generator=g, device=device)]


def hash_params(seed: int, rows: int, device) -> torch.Tensor:
    """(6, rows) int64 uint32 limbs (a1_hi, a1_lo, a2_hi, a2_lo, b_hi,
    b_lo) of the sketch's multiply-shift hashes."""
    return torch.randint(0, 1 << 32, (6, rows), generator=generator(
        seed, 1, device), device=device, dtype=torch.int64)


def jitter(seed: int, slots: int, replicas: int, dims: int, frac: float,
           device) -> torch.Tensor:
    """(slots, replicas, dims) offsets in cell units, uniform in
    [−frac, frac]: replica j of heavy hitter i sits at its cell's centre
    plus jitter[i, j] cells."""
    u = torch.rand((slots, replicas, dims), generator=generator(
        seed, 2, device), device=device)
    return (2.0 * u - 1.0) * frac
