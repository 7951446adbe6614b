"""UMAP (McInnes-Healy-Melville 2018), epoch-batched, on tensors — the
paper's embedder and the port's first.

* kNN graph (``neighbors.knn_graph``: exact, or approximate above 2¹⁶
  points),
* fuzzy simplicial set: per-point rho (nearest distance) and sigma by
  bisection so Σ_j exp(−(d−rho)/sigma) = log₂(k), symmetrized by the
  probabilistic t-conorm a ⊕ a' = a + a' − a·a',
* (a, b) curve fit from (spread, min_dist) on the host,
* epoch-batched SGD with negative sampling: each epoch applies the
  attraction of every edge and ``neg_rate`` uniform repulsive samples per
  edge, as the reference (``repro.core.umap``) does.

Each epoch reduces its per-edge forces into per-point deltas with two
segment reductions over a sorted-COO layout built once
(``coo.edge_layout``); on the card both run the hand-written kernel.

Random draws come from a ``torch.Generator`` (uniform init, then one
(E, neg_rate) batch of negatives per epoch); ``init=`` and
``negatives=`` take them from outside instead, which is how the tests
carry the reference's draws across.

Mesh-parallel path (``run_umap(mesh=...)``: ``None`` | rank count | 1-D
``DeviceMesh``, see ``core.mesh``): every rank runs the loop over its
own row block of y and the matching contiguous slice of the src-sorted
edge list (``coo.ShardedEdgeLayout``).  Each epoch is one all-gather of
the blocks and one all-reduce of the (n_padded, dims) dst-side partial,
nothing else; K1 runs twice a rank (the local src side, the global dst
side).  Every rank draws the full (E, neg_rate) negatives from the same
seeded generator (or takes the fed ``negatives[i]``) and gathers its
slots by ``edge_ids``, so the run is draw for draw the single-device
one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import coo
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import neighbors, spans
from repro_torch.core.tsne import validate_init


@dataclasses.dataclass(frozen=True)
class UmapConfig:
    dims: int = 2
    n_neighbors: int = 15
    min_dist: float = 0.1
    spread: float = 1.0
    n_epochs: int = 300
    learning_rate: float = 1.0
    neg_rate: int = 5
    init_scale: float = 10.0
    sigma_search_iters: int = 50
    block: int = 4096              # kNN row-block; N <= block -> one block
    # kNN build: "exact" | "auto" (exact up to 2¹⁶ points) | "ann" (the
    # approximate engine, core.ann); ``ann`` an ann.AnnConfig
    knn_method: str = "auto"
    ann: Optional[object] = None


@functools.lru_cache(maxsize=None)
def fit_ab(spread: float, min_dist: float) -> Tuple[float, float]:
    """Least-squares fit of 1/(1+a d^{2b}) to the target membership curve
    (host scipy, as umap-learn does), cached per (spread, min_dist)."""
    from scipy.optimize import curve_fit
    xs = np.linspace(0, 3.0 * spread, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xs, ys, p0=(1.0, 1.0), maxfev=10_000)
    return float(a), float(b)


@spans.spanned("affinity")
def fuzzy_simplicial_set(knn_idx: torch.Tensor, knn_dist: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         search_iters: int = 50, symmetrize: str = "sparse"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Memberships on the kNN edges, symmetrized.

    Returns (edges (E, 2) int64, membership (E,) float32), E = N·k, the
    edge list in src-sorted order.  ``symmetrize="sparse"`` (default)
    finds each edge's reverse by binary search, with no (N, N) temporary;
    ``"dense"`` is the reference's scatter-max path for small N: an
    (N, N) membership matrix."""
    if symmetrize not in ("sparse", "dense"):
        raise ValueError(f"unknown symmetrize {symmetrize!r}")
    n, k = knn_idx.shape
    dev = knn_dist.device
    rho = knn_dist[:, 0]
    # jnp.log2's arithmetic: log(k) / log(2) in float32
    target = torch.log(torch.tensor(float(k))) / torch.log(torch.tensor(2.0))
    target = target.to(dev)
    lo = torch.full((n,), 1e-6, device=dev)
    hi = torch.full((n,), 1e6, device=dev)
    d = (knn_dist - rho[:, None]).clamp(min=0.0)
    for _ in range(search_iters):
        mid = 0.5 * (lo + hi)
        s = torch.exp(-d / mid[:, None]).sum(1)
        too_big = s > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    sigma = 0.5 * (lo + hi)
    memb = torch.exp(-d / sigma[:, None])                     # (N, k)
    if weights is not None:
        w = weights / weights.mean()
        memb = (memb * w[:, None]).clamp(max=1.0)
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = knn_idx.reshape(-1)
    vals = memb.reshape(-1)
    edges = torch.stack([rows, cols], 1)
    if symmetrize == "dense":
        dense = torch.zeros((n, n), dtype=vals.dtype, device=dev)
        dense.view(-1).scatter_reduce_(0, rows * n + cols, vals, "amax")
        sym = dense + dense.T - dense * dense.T
        return edges, sym[rows, cols]
    rev = neighbors.reverse_edge_values(knn_idx, memb, rows, cols, vals, n)
    return edges, vals + rev - vals * rev


def _edge_forces(y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 memb_n: torch.Tensor, neg: torch.Tensor, a: float, b: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (attraction, attraction + the summed repulsion of the
    edge's ``neg`` samples), each (E, dims), from the positions ``y``."""
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


def epoch_delta(y: torch.Tensor, layout: coo.EdgeLayout, memb_n: torch.Tensor,
                neg: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """One epoch's per-point SGD delta.

    ``neg`` is the epoch's (E, neg_rate) int64 negative samples.
    Attraction and repulsion are computed per edge, then reduced into
    per-point deltas by two segment reductions: the src side carries
    attraction + negative samples, the dst side the attraction reaction."""
    att, src_side = _edge_forces(y, layout.src, layout.dst, memb_n, neg, a, b)
    return coo.segment_reduce(src_side, layout.src_bounds) \
        - coo.segment_reduce(att[layout.dst_order].contiguous(),
                             layout.dst_bounds)


def epoch_delta_shard(y_full: torch.Tensor, lay: coo.EdgeBlock,
                      memb_n: torch.Tensor, neg: torch.Tensor, a: float,
                      b: float, mesh, axis: str) -> torch.Tensor:
    """One epoch's delta for THIS rank's row block: :func:`epoch_delta`
    on the rank's edge slice.

    ``y_full`` is the all-gathered (n_padded, dims) positions, ``lay``
    the rank's :class:`coo.EdgeBlock`, ``memb_n`` its (Ep,) memberships
    (zero on padded slots), ``neg`` its (Ep, neg_rate) negatives (the
    full draw gathered by ``lay.edge_ids``).  The src side reduces over
    local rows; the dst side (the attraction reaction) reduces into a
    full-length partial that crosses ranks as ONE all-reduce.  Returns
    (rows_per, dims)."""
    att, src_side = _edge_forces(y_full, lay.src, lay.dst, memb_n, neg, a, b)
    src_red = coo.segment_reduce(src_side, lay.src_bounds)
    dst_part = coo.segment_reduce(att[lay.dst_order].contiguous(),
                                  lay.dst_bounds)       # (n_padded, dims)
    dst_tot = mesh_mod.all_reduce(dst_part, mesh, axis)  # THE dst exchange
    rows_per = lay.src_bounds.shape[0] - 1
    return src_red - dst_tot[lay.row_offset:lay.row_offset + rows_per]


def _alpha(cfg: UmapConfig, i: int) -> float:
    """The reference's float32 schedule: lr · (1 − f32(i) / f32(n_epochs))."""
    return float(np.float32(cfg.learning_rate) * (
        np.float32(1.0) - np.float32(i) / np.float32(cfg.n_epochs)))


def _init_and_negatives(n: int, e: int, cfg: UmapConfig, dev,
                        init: Optional[torch.Tensor],
                        generator: Optional[torch.Generator],
                        negatives: Optional[torch.Tensor]):
    """(y0, negatives of epoch i as a function): the given ones, else
    drawn from ``generator`` in the order of the single-device loop
    (init first, then one (E, neg_rate) batch an epoch)."""
    if init is None:
        y = cfg.init_scale * torch.rand((n, cfg.dims), generator=generator,
                                        device=dev) - cfg.init_scale / 2.0
    else:
        y = init.to(dev)

    def neg(i):
        if negatives is None:
            return torch.randint(0, n, (e, cfg.neg_rate),
                                 generator=generator, device=dev)
        return negatives[i].to(dev)
    return y, neg


def optimize_embedding(edges: torch.Tensor, memb: torch.Tensor, n: int,
                       cfg: UmapConfig, init: Optional[torch.Tensor] = None,
                       *, generator: Optional[torch.Generator] = None,
                       negatives: Optional[torch.Tensor] = None,
                       mesh=None) -> torch.Tensor:
    """Epoch-batched SGD on the UMAP cross-entropy.

    ``init`` (N, dims) replaces the uniform cold start; ``negatives``
    (n_epochs, E, neg_rate) replaces the per-epoch draws.  Whatever is
    not given comes from ``generator``.  With ``mesh`` the loop runs
    row-block-sharded over the ranks of its first dimension (see the
    module docstring); every rank returns the whole (N, dims)."""
    mesh = mesh_mod.resolve_mesh(mesh)
    dev = memb.device
    with spans.span("layout"):
        a, b = fit_ab(cfg.spread, cfg.min_dist)
        layout, order = coo.edge_layout(edges[:, 0], edges[:, 1], n)
        memb_n = (memb / memb.max().clamp(min=1e-12))[order]
        e = layout.src.shape[0]
        y, neg = _init_and_negatives(n, e, cfg, dev, init, generator,
                                     negatives)
        if mesh is not None:
            axis = mesh_mod.mesh_axis(mesh)
            s = mesh.get_local_rank(axis)
            slay = coo.shard_edge_layout(layout.src.cpu().numpy(),
                                         layout.dst.cpu().numpy(), n,
                                         mesh_mod.axis_size(mesh, axis))
            lay = slay.block(s, dev)
            memb_b = coo.shard_payload(lay, memb_n)
            rows_per = slay.rows_per_shard
            y = torch.cat([y, y.new_zeros((slay.n_padded - n, y.shape[1]))])
            y_blk = y[lay.row_offset:lay.row_offset + rows_per].clone()
            del y
    with spans.span("optimize"):
        if mesh is None:
            for i in range(cfg.n_epochs):
                y = y + _alpha(cfg, i) * epoch_delta(y, layout, memb_n,
                                                     neg(i), a, b)
            return y
        for i in range(cfg.n_epochs):
            neg_b = neg(i)[lay.edge_ids]
            y_full = mesh_mod.all_gather(y_blk, mesh, axis)
            y_blk = y_blk + _alpha(cfg, i) * epoch_delta_shard(
                y_full, lay, memb_b, neg_b, a, b, mesh, axis)
        return mesh_mod.all_gather(y_blk, mesh, axis)[:n]


def run_umap(x: torch.Tensor, cfg: UmapConfig,
             weights: Optional[torch.Tensor] = None, mesh=None,
             init: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             negatives: Optional[torch.Tensor] = None,
             ann_draws=None) -> torch.Tensor:
    """Full UMAP on ``x``'s device: kNN → fuzzy set → SGD.  (N, dims).

    ``init`` seeds the SGD at given (N, dims) coordinates instead of the
    uniform cold start (validated for shape and dtype); ``ann_draws``
    goes to an approximate kNN build.  ``mesh`` row-block-shards the
    exact kNN build and the SGD loop over the ranks (every rank passes
    the same ``x`` and gets the whole embedding); the fuzzy set is built
    whole on every rank."""
    mesh = mesh_mod.resolve_mesh(mesh)
    init = validate_init(init, x.shape[0], cfg.dims)
    idx, dist = neighbors.knn_graph(x, cfg.n_neighbors, block=cfg.block,
                                    mesh=mesh, method=cfg.knn_method,
                                    ann=cfg.ann, ann_draws=ann_draws)
    edges, memb = fuzzy_simplicial_set(idx, dist, weights=weights,
                                       search_iters=cfg.sigma_search_iters)
    return optimize_embedding(edges, memb, x.shape[0], cfg, init=init,
                              generator=generator, negatives=negatives,
                              mesh=mesh)
