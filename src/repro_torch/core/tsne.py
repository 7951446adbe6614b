"""The two tSNE helpers the UMAP path shares: warm-start validation and
squared distances.  The tSNE embedder itself is not ported yet (ROADMAP
P8 sparse, P10 exact)."""
from __future__ import annotations

from typing import Optional

import torch


def validate_init(init, n: int, dims: int) -> Optional[torch.Tensor]:
    """Shape/dtype-check a warm-start embedding init.  Accepts None (cold
    start) or an (N, dims) float array; returns it as float32 or raises
    with the offending shape/dtype."""
    if init is None:
        return None
    init = torch.as_tensor(init)
    if tuple(init.shape) != (n, dims):
        raise ValueError(
            f"init must have shape ({n}, {dims}) to seed the embedding; "
            f"got {tuple(init.shape)}")
    if not init.is_floating_point():
        raise ValueError(f"init must be a float array; got {init.dtype}")
    return init.to(torch.float32)


def pairwise_sq_dists(x: torch.Tensor, y: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Squared Euclidean distances via the Gram-matrix identity, clipped
    at 0 (one fp32 matmul; TF32 is off by PyTorch's default)."""
    y = x if y is None else y
    xx = (x * x).sum(1)
    yy = (y * y).sum(1)
    d = xx[:, None] - 2.0 * (x @ y.T) + yy[None, :]
    return d.clamp_(min=0.0)
