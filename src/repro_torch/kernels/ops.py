"""The reference's fused-ingest entry points (``repro.kernels.ops``) on
the port's kernels.

* :func:`hash_points` — quantize → pack → hash of a point block (K6,
  ``kernels/hash_points.py``);
* :func:`sketch_update_fused` — hash + signed accumulate into a fresh
  (R, C) table added to the sketch's (K7, ``kernels/sketch_update.py``);
* :func:`sketch_estimate_mxu` — hash, signed per-row gather and the
  median over rows in one kernel (K8, ``kernels/sketch_estimate.py``;
  the mean of the two middle rows for even R, as ``jnp.median``).

CUDA tensors launch the kernels or raise; CPU tensors take their plain
twins.  The reference's ``use_kernel``, ``interpret`` and TPU tile sizes
(``block_items``, ``block_q``, ``block_c``) are dropped: they chose VMEM
blocks and Pallas's interpreter, which the CUDA kernels do not have, and
the tensors' device already chooses the kernel.  The reference's
C ≤ 2¹⁶ bound of ``sketch_update_fused`` (a VMEM limit of its TPU
kernel) is kept, so the wrapper fails where the reference's fails;
``sketch.update`` has no such bound in either package.

The reference's other wrappers have their counterparts beside their
kernels: ``cic_splat`` and ``cic_gather`` in ``kernels/cic.py``,
``tsne_step_fused`` in ``kernels/tsne_forces.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.quantize import GridSpec
from repro_torch.core.sketch import CountSketch
from repro_torch.kernels import hash_points as _hp
from repro_torch.kernels.sketch_estimate import estimate
from repro_torch.kernels.sketch_update import sketch_update


def hash_points(params: MulShiftParams, grid: GridSpec, points: torch.Tensor,
                log2_cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused quantize + pack + hash: (buckets (R, N), signs (R, N)),
    int64."""
    return _hp.hash_points(params, grid, points.contiguous(), log2_cols)


def sketch_update_fused(sk: CountSketch, key_hi: torch.Tensor,
                        key_lo: torch.Tensor,
                        values: Optional[torch.Tensor] = None) -> CountSketch:
    """Hash + accumulate the items into a fresh table, added to the
    sketch's (C ≤ 2¹⁶).  Semantics identical to ``sketch.update``."""
    if sk.table.shape[1] > (1 << 16):
        raise ValueError(
            f"kernel path supports C <= 2^16 (VMEM-resident table); "
            f"got C={sk.table.shape[1]}.  Use sketch.update_sorted for bulk "
            f"streams.")
    v = torch.ones(key_hi.shape, dtype=torch.float32, device=key_hi.device) \
        if values is None else values.to(torch.float32)
    delta = torch.zeros(sk.table.shape, dtype=torch.float32,
                        device=sk.table.device)
    sketch_update(delta, sk.params, key_hi.contiguous(), key_lo.contiguous(),
                  v.contiguous())
    return sk._replace(table=sk.table + delta.to(sk.table.dtype))


def sketch_estimate_mxu(sk: CountSketch, key_hi: torch.Tensor,
                        key_lo: torch.Tensor) -> torch.Tensor:
    """Median over rows of the signed table values at the keys' buckets,
    (Q,) float32."""
    return estimate(sk.table.to(torch.float32).contiguous(), sk.params,
                    key_hi.contiguous(), key_lo.contiguous())
