"""Masked squared-distance tiles (K4) for the approximate kNN's candidate
stage: the CUDA kernel and its plain twin.

``core.ann`` sorts the points by grid-cell key and cuts them into tiles
of B sorted rows; each tile scores a shared window of C = 3B candidates
(its own rows and a one-tile halo on each side).  For qx (T, B, D), qid
(T, B), cx (T, C, D), cid (T, C) the result is (T, B, C) float32

    d²(q, c) = max(|q|² + |c|² − 2·q·c, 0),

set to +inf where ``cid < 0`` (window padding) or ``cid == qid`` (self
pairs): the reference's ``repro.kernels.knn_tile``.

* :func:`distance_tiles_cuda` launches ``csrc/knn_tile.cu`` (one block
  per tile and 128 candidate columns; the source note says what bounds
  it).  CUDA tensors only, float32 coordinates and int32 ids, 1 ≤ D ≤ 64.
* :func:`distance_tiles_torch` is the plain version,
  ``_distance_tiles_xla``'s arithmetic in the coordinates' dtype
  (float32, or float64 for the card's checks).
* :func:`distance_tiles` dispatches by device: a CUDA tensor launches the
  kernel or raises, a CPU tensor takes the twin.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# (qx, qid, cx, cid, out, t, b, c, d, stream)
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
MAX_DIMS = 64


def _check(qx: torch.Tensor, qid: torch.Tensor, cx: torch.Tensor,
           cid: torch.Tensor) -> None:
    ts = (qx, qid, cx, cid)
    if not all(t.is_cuda for t in ts):
        raise ValueError("distance_tiles_cuda takes CUDA tensors; got "
                         + ", ".join(str(t.device) for t in ts))
    if len({t.device for t in ts}) != 1:
        raise ValueError("distance_tiles: tensors on different devices")
    if qx.dtype != torch.float32 or cx.dtype != torch.float32:
        raise ValueError(f"distance_tiles: qx and cx must be float32, got "
                         f"{qx.dtype} and {cx.dtype}")
    if qid.dtype != torch.int32 or cid.dtype != torch.int32:
        raise ValueError(f"distance_tiles: qid and cid must be int32, got "
                         f"{qid.dtype} and {cid.dtype}")
    if qx.dim() != 3 or cx.dim() != 3:
        raise ValueError(f"distance_tiles: need qx (T, B, D) and cx "
                         f"(T, C, D); got {tuple(qx.shape)} and "
                         f"{tuple(cx.shape)}")
    t, b, d = qx.shape
    c = cx.shape[1]
    if cx.shape != (t, c, d) or qid.shape != (t, b) or cid.shape != (t, c):
        raise ValueError(f"distance_tiles: shapes disagree: qx "
                         f"{tuple(qx.shape)}, qid {tuple(qid.shape)}, cx "
                         f"{tuple(cx.shape)}, cid {tuple(cid.shape)}")
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"distance_tiles: D must be in [1, {MAX_DIMS}], "
                         f"got {d}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("distance_tiles: tensors must be contiguous")


def distance_tiles_cuda(qx: torch.Tensor, qid: torch.Tensor,
                        cx: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
    """(T, B, C) masked squared distances by the hand-written kernel."""
    _check(qx, qid, cx, cid)
    t, b, d = qx.shape
    c = cx.shape[1]
    out = torch.empty((t, b, c), dtype=torch.float32, device=qx.device)
    if t and b and c:
        fn = _build.entry("knn_tile", "knn_dist_tiles_f32", _SIG)
        _build.launch("knn_dist_tiles", fn, qx.device, qx.data_ptr(),
                      qid.data_ptr(), cx.data_ptr(), cid.data_ptr(),
                      out.data_ptr(), t, b, c, d)
    return out


def distance_tiles_torch(qx: torch.Tensor, qid: torch.Tensor,
                         cx: torch.Tensor, cid: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version: norms plus an ``einsum`` cross term, clamped at 0,
    masked to +inf; float64 coordinates stay float64."""
    dt = torch.float64 if qx.dtype == torch.float64 else torch.float32
    qx, cx = qx.to(dt), cx.to(dt)
    qq = (qx * qx).sum(2)                                   # (T, B)
    cc = (cx * cx).sum(2)                                   # (T, C)
    cross = torch.einsum("tbd,tcd->tbc", qx, cx)
    d2 = (qq[:, :, None] + cc[:, None, :] - 2.0 * cross).clamp_(min=0.0)
    invalid = (cid[:, None, :] < 0) | (cid[:, None, :] == qid[:, :, None])
    return d2.masked_fill_(invalid, float("inf"))


def distance_tiles(qx: torch.Tensor, qid: torch.Tensor, cx: torch.Tensor,
                   cid: torch.Tensor) -> torch.Tensor:
    """Masked squared-distance blocks for T query tiles: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if qx.is_cuda:
        return distance_tiles_cuda(qx, qid, cx, cid)
    return distance_tiles_torch(qx, qid, cx, cid)
