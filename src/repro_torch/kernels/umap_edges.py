"""UMAP's per-edge epoch forces (K9): the CUDA kernel and its plain twin.

For the src-sorted edge list (``src``, ``dst``), the positions ``y`` (N,
dims), the normalized memberships ``memb_n`` (E,) and the epoch's
negatives ``neg`` (E, R) int64, every edge's clipped attraction and the
clipped repulsion of its R negative samples (those equal to the edge's
own src or dst left out), each times the edge's membership: the
reference's per-edge forces (``repro.core.umap``).  Two (E, dims) float32
payloads come back, one for each of the epoch's segment reductions (K1):

* ``src_side``, the attraction plus the summed repulsion, in src order;
* ``att``, the attraction, in dst-sorted order: edge e's row at
  ``dst_pos[e]``, the inverse of the layout's ``dst_order``.

* :func:`umap_edge_forces_cuda` launches ``csrc/umap_edges.cu`` (one
  thread an edge; the source note says what bounds it).  CUDA tensors
  only, float32 positions of 1 to 8 dims, int64 ids and negatives; it
  raises on anything else.
* :func:`umap_edge_forces_torch` is the plain version: :func:`edge_forces`
  (the forces in edge order, op by op) and the attraction put in dst
  order, which gives the same values as gathering it by ``dst_order``.
* :func:`umap_edge_forces` dispatches by device: a CUDA tensor launches
  the kernel or raises, a CPU tensor takes the twin.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

# (y, src, dst, memb, neg, dst_pos, src_side, att, e, d, r, a, b, b - 1,
#  -2ab, 2b, stream)
_SIG = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
        + [ctypes.c_float] * 5 + [ctypes.c_void_p])
MAX_DIMS = 8


def edge_forces(y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                memb_n: torch.Tensor, neg: torch.Tensor, a: float, b: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (attraction, attraction + the summed repulsion of the
    edge's ``neg`` samples), each (E, dims), from the positions ``y``,
    in edge order."""
    ys, yd = y[src], y[dst]
    diff = ys - yd
    d2 = (diff * diff).sum(1)
    # attractive: dCE/dy = 2ab d^{2(b-1)} / (1 + a d^{2b}) * (ys - yd)
    grad_coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
    grad_coef = torch.where(d2 > 0, grad_coef, 0.0)
    att = (grad_coef[:, None] * diff).clamp(-4.0, 4.0) * memb_n[:, None]
    # repulsive: samples that hit the edge's own endpoints are masked out
    # (static shapes, umap-learn's "skip self" in expectation)
    valid = (neg != src[:, None]) & (neg != dst[:, None])
    ndiff = ys[:, None, :] - y[neg]                          # (E, R, dims)
    dn2 = (ndiff * ndiff).sum(2)
    rep_coef = (2.0 * b) / ((0.001 + dn2) * (1.0 + a * dn2 ** b))
    rep = (rep_coef[..., None] * ndiff).clamp(-4.0, 4.0) \
        * memb_n[:, None, None]
    rep = torch.where(valid[..., None], rep, 0.0)
    return att, att + rep.sum(1)


def umap_edge_forces_torch(y: torch.Tensor, src: torch.Tensor,
                           dst: torch.Tensor, memb_n: torch.Tensor,
                           neg: torch.Tensor, dst_pos: torch.Tensor,
                           a: float, b: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (src_side, att in dst order), each (E, dims)."""
    att, src_side = edge_forces(y, src, dst, memb_n, neg, a, b)
    return src_side, torch.empty_like(att).index_copy_(0, dst_pos, att)


def _check(y, src, dst, memb_n, neg, dst_pos) -> None:
    ts = (y, src, dst, memb_n, neg, dst_pos)
    dev = y.device
    if not (y.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError("umap_edge_forces_cuda takes CUDA tensors on one "
                         "device; got " + ", ".join(str(t.device) for t in ts))
    if y.dtype != torch.float32 or memb_n.dtype != torch.float32:
        raise ValueError(f"umap_edge_forces: y and memb_n must be float32, "
                         f"got {y.dtype} and {memb_n.dtype}")
    if not (src.dtype == dst.dtype == neg.dtype == dst_pos.dtype
            == torch.int64):
        raise ValueError(f"umap_edge_forces: src, dst, neg and dst_pos must "
                         f"be int64, got {src.dtype}, {dst.dtype}, "
                         f"{neg.dtype} and {dst_pos.dtype}")
    e = src.shape[0]
    if not (y.dim() == neg.dim() == 2 and src.dim() == 1
            and dst.shape == memb_n.shape == dst_pos.shape == src.shape
            and neg.shape[0] == e):
        raise ValueError(
            f"umap_edge_forces: need y (N, dims), src, dst, memb_n, dst_pos "
            f"(E,) and neg (E, R); got {tuple(y.shape)}, {tuple(src.shape)}, "
            f"{tuple(dst.shape)}, {tuple(memb_n.shape)}, "
            f"{tuple(dst_pos.shape)} and {tuple(neg.shape)}")
    d = y.shape[1]
    if not 1 <= d <= MAX_DIMS:
        raise ValueError(f"umap_edge_forces: dims must be in [1, {MAX_DIMS}]"
                         f", got {d}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("umap_edge_forces: tensors must be contiguous")
    if d in (2, 4) and y.data_ptr() % (4 * d):
        raise ValueError(f"umap_edge_forces: y (N, {d}) must be {4 * d}-byte "
                         f"aligned: the kernel reads each row as one vector")


def umap_edge_forces_cuda(y: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, memb_n: torch.Tensor,
                          neg: torch.Tensor, dst_pos: torch.Tensor,
                          a: float, b: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src_side, att in dst order) by the hand-written kernel.  Every id
    in ``src``, ``dst`` and ``neg`` must lie in [0, N) and ``dst_pos`` be
    a permutation of [0, E): the caller's contract (``coo.edge_layout``'s
    output), not checked here, as checking would wait on the card."""
    _check(y, src, dst, memb_n, neg, dst_pos)
    e, d = src.shape[0], y.shape[1]
    src_side = torch.empty((e, d), dtype=torch.float32, device=y.device)
    att = torch.empty((e, d), dtype=torch.float32, device=y.device)
    if e:
        fn = _build.entry("umap_edges", "umap_edge_forces_f32", _SIG)
        # the plain chain's scalars, each rounded to fp32 as PyTorch
        # rounds a Python float it multiplies a float32 tensor by
        _build.launch("umap_edge_forces", fn, y.device, y.data_ptr(),
                      src.data_ptr(), dst.data_ptr(), memb_n.data_ptr(),
                      neg.data_ptr(), dst_pos.data_ptr(), src_side.data_ptr(),
                      att.data_ptr(), e, d, neg.shape[1], a, b, b - 1.0,
                      -2.0 * a * b, 2.0 * b)
    return src_side, att


def umap_edge_forces(y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     memb_n: torch.Tensor, neg: torch.Tensor,
                     dst_pos: torch.Tensor, a: float, b: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src_side, att in dst order): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if y.is_cuda:
        return umap_edge_forces_cuda(y, src, dst, memb_n, neg, dst_pos, a, b)
    return umap_edge_forces_torch(y, src, dst, memb_n, neg, dst_pos, a, b)
