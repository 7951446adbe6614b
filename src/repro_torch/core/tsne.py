"""tSNE on tensors — the paper's other embedder, four gradient backends.

Faithful to van der Maaten & Hinton 2008 and to the JAX reference
(``repro.core.tsne``):

* per-point perplexity calibration by a fixed 50-step bisection over
  beta = 1/(2σ²), streamed in row blocks;
* weighted symmetrized P_ij = ½(w_i·pc(j|i) + w_j·pc(i|j)) rebuilt from
  per-point :class:`PointStats` [beta, shift, zp, w];
* early exaggeration, momentum and per-parameter gains, recentering;
* exact gradient 4·Σ_j (p_ij − q_ij)(y_i − y_j)/(1 + |y_i − y_j|²).

Backends (``TsneConfig.backend``):

``dense``   (N, N) P and Q — plain torch on either device;
``tiled``   row blocks, O(block·N) memory — the fused gradient's plain
            twins, plain torch on either device;
``pallas``  the fused two-pass gradient, named as in the reference: on
            the card the hand-written kernels K5a ``tsne_z`` and K5b
            ``tsne_forces`` (``kernels/tsne_forces.py``), on the CPU their
            plain twins, the rows in a locality order of x computed once
            a run (K5b skips the attraction of far row and column
            groups);
``sparse``  kNN attraction through the segment-reduce kernel K1
            (``coo.segment_reduce``) and FFT-grid repulsion: the
            cloud-in-cell splat K2 and gather K3 (``kernels/cic.py``)
            around ``torch.fft.rfft2/irfft2`` (the reference leaves the
            FFT to XLA, outside any Pallas kernel).

Every kernel is picked by the tensors' device: a CUDA tensor launches
it or raises, a CPU tensor takes its twin.  The optimizer loop runs
eagerly on the device; its KL trace stays there (one slot per
iteration, no host read), and only the adaptive grid reads the
embedding's span back, once per stage, as the reference does.

The sparse backend's kNN graph is exact or approximate
(``knn_method="ann"``, and ``"auto"`` above 2¹⁶ points: ``core.ann``
with the distance-tile kernel K4).

Mesh-parallel sparse backend (``run_tsne(mesh=...)``: ``None`` | rank
count | 1-D ``DeviceMesh``, see ``core.mesh``): every rank passes the same
``x`` and runs the optimizer over its own contiguous row block of the
state.  The kNN graph is built sharded (``knn_graph(mesh=)``, exact or
approximate) and the symmetrized P replicated; each rank then cuts its
block of the src-sorted edge list on the device (:func:`sparse_p_block`,
the contiguous slice ``bounds[lo]:bounds[hi]``), so the attraction is a
local K1 and needs no dst-side exchange.  Repulsion: each rank splats its
own rows (K2), one all-reduce sums the (3, G, G) grid (with the KL's two
partials riding along), the FFT runs replicated and each rank gathers
its own rows back (K3).  An iteration's collectives are one all-gather
of the blocks and three all-reduces (grid and KL partials, Z, the
centering mean); the adaptive G reads an all-reduced min/max once a
stage, so every rank picks the same G.  Every rank draws the full init
from the same generator and returns the whole embedding and KL trace.
Per-iteration quantities match the single-device path to fp tolerance;
long runs decohere, as any change of summation order must under this
optimizer.  The exact backends refuse a mesh, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import coo
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import spans
from repro_torch.kernels import cic
from repro_torch.kernels import tsne_forces as fused

BACKENDS = ("dense", "tiled", "pallas", "sparse")
CIC_PATHS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class TsneConfig:
    """The reference's fields, less ``kernel_mode``: the port's kernels
    are chosen by the tensors' device."""
    dims: int = 2
    perplexity: float = 30.0
    n_iter: int = 500
    early_exaggeration: float = 12.0
    exaggeration_iters: int = 125
    learning_rate: float = 200.0
    momentum_start: float = 0.5
    momentum_final: float = 0.8
    momentum_switch: int = 125
    min_gain: float = 0.01
    sigma_search_iters: int = 50
    backend: str = "dense"         # "dense" | "tiled" | "pallas" | "sparse"
    block: int = 512               # row-block for calibration / tiled / pallas
    knn: int = 0                   # sparse: neighbors per point (0 → 3·perp)
    grid_size: int = 128           # sparse: FFT repulsion grid, G per axis
    # adaptive grid: > 0 makes grid_size the starting G and fixes the
    # target cell spacing; G doubles (up to grid_max) when the span
    # outgrows it, checked every adaptive_interval iterations
    grid_interval: float = 0.0     # 0 = fixed-G; > 0 = target cell spacing
    grid_max: int = 1024           # adaptive: G cap (bounds the FFT cost)
    adaptive_interval: int = 50    # adaptive: iterations between G checks
    # "xla" | "pallas": validated so the reference's configs carry over,
    # but it selects nothing here — the splat and gather always run
    # through kernels/cic.py, whose kernel or twin the device picks
    cic: str = "xla"
    # sparse kNN build: "exact" | "auto" (exact up to 2¹⁶ points) | "ann"
    # (the approximate engine, core.ann); ``ann`` an ann.AnnConfig
    knn_method: str = "auto"
    ann: Optional[object] = None


class PointStats(NamedTuple):
    """Per-point sufficient statistics for rebuilding P on the fly.

    pc(j|i) = exp(−beta_i·d²(x_i, x_j) − shift_i) / zp_i   (0 on the diag),
    P_ij    = ½ (w_i·pc(j|i) + w_j·pc(i|j)),   Σ_ij P_ij = 1.
    """
    beta: torch.Tensor   # (N,) precision 1/(2 sigma²)
    shift: torch.Tensor  # (N,) row max of −beta_i·d², subtracted pre-exp
    zp: torch.Tensor     # (N,) shifted row normalizer
    w: torch.Tensor      # (N,) normalized point mass, Σ w = 1


def validate_init(init, n: int, dims: int) -> Optional[torch.Tensor]:
    """Shape/dtype-check a warm-start embedding init (both embedders).
    Accepts None (cold start) or an (N, dims) float array; returns it as
    float32 or raises with the offending shape/dtype."""
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


def _target_entropy(perplexity: float, device) -> torch.Tensor:
    """``jnp.log(perplexity)``: the log taken in float32."""
    return torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                  device=device))


def _rows_probs_entropy(neg_d: torch.Tensor, beta: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise conditional P and Shannon entropy for precision beta.
    neg_d: (B, N) negative squared distances, −inf at invalid pairs."""
    logits = neg_d * beta[:, None]
    logits = logits - logits.max(1, keepdim=True).values
    p = torch.exp(logits)
    p_sum = p.sum(1, keepdim=True)
    p = p / p_sum
    logp = logits - torch.log(p_sum)
    h = -torch.where(p > 0, p * logp, 0.0).sum(1)
    return p, h


def _beta_search(neg_d: torch.Tensor, target_h: torch.Tensor,
                 search_iters: int) -> torch.Tensor:
    """Per-row bisection for beta matching the target entropy, a fixed
    number of steps (the same on a full row and on a kNN row)."""
    rows = neg_d.shape[0]
    beta = torch.ones((rows,), device=neg_d.device)
    lo = torch.zeros((rows,), device=neg_d.device)
    hi = torch.full((rows,), math.inf, device=neg_d.device)
    for _ in range(search_iters):
        _, h = _rows_probs_entropy(neg_d, beta)
        too_entropic = h > target_h             # entropy high -> raise beta
        lo = torch.where(too_entropic, beta, lo)
        hi = torch.where(too_entropic, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    return beta


def _point_mass(weights: Optional[torch.Tensor], n: int, device
                ) -> torch.Tensor:
    if weights is not None:
        return weights / weights.sum()
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def calibrate_stats(x: torch.Tensor, perplexity: float,
                    weights: Optional[torch.Tensor] = None,
                    search_iters: int = 50, block: int = 512) -> PointStats:
    """Perplexity calibration in row blocks — peak memory O(block · N)."""
    n = x.shape[0]
    block = min(block, n) if n > 0 else block
    cols = torch.arange(n, device=x.device)
    target_h = _target_entropy(perplexity, x.device)
    parts = ([], [], [])
    for lo in range(0, n, block):
        d2 = pairwise_sq_dists(x[lo:lo + block], x)       # (B, N)
        valid = cols[lo:lo + block, None] != cols[None, :]
        neg_d = torch.where(valid, -d2, -math.inf)
        beta = _beta_search(neg_d, target_h, search_iters)
        logits = torch.where(valid, -d2 * beta[:, None], -math.inf)
        shift = logits.max(1).values
        zp = torch.exp(logits - shift[:, None]).sum(1)
        for acc, t in zip(parts, (beta, shift, zp)):
            acc.append(t)
    beta, shift, zp = (torch.cat(t) if t else x.new_zeros((0,))
                       for t in parts)
    return PointStats(beta=beta, shift=shift, zp=zp,
                      w=_point_mass(weights, n, x.device))


def p_from_stats(x: torch.Tensor, stats: PointStats) -> torch.Tensor:
    """Dense joint P from per-point stats (the O(N²) reconstruction)."""
    d2 = pairwise_sq_dists(x)
    pc = torch.exp(-stats.beta[:, None] * d2 - stats.shift[:, None]) \
        / stats.zp[:, None]
    pc.fill_diagonal_(0.0)
    wpc = stats.w[:, None] * pc
    p = 0.5 * (wpc + wpc.T)
    p = p / p.sum()
    return p.clamp(min=1e-12)


def calibrate_p(x: torch.Tensor, perplexity: float,
                weights: Optional[torch.Tensor] = None,
                search_iters: int = 50, block: int = 512) -> torch.Tensor:
    """Joint symmetrized P (dense) over the blocked calibration."""
    return p_from_stats(x, calibrate_stats(
        x, perplexity, weights=weights, search_iters=search_iters,
        block=block))


# ----------------------------------------------------------- sparse backend
# Per iteration O(N·k + G²·log G): attraction over the symmetrized kNN
# support (gather + K1 segment reduce over the src-sorted COO edges),
# repulsion and Z from one particle-mesh pass (K2 splat, FFT, K3 gather).

class SparseP(NamedTuple):
    """Symmetrized joint P on the kNN support, fixed-shape COO, sorted by
    (src, dst); duplicate slots carry val 0 and Σ val = 1.
    ``bounds[i]:bounds[i+1]`` is row i's slice of the edge list."""
    src: torch.Tensor     # (E,) int64, E = 2·N·k, sorted
    dst: torch.Tensor     # (E,) int64
    val: torch.Tensor     # (E,) float32
    bounds: torch.Tensor  # (N+1,) int32


def calibrate_stats_knn(knn_dist: torch.Tensor, perplexity: float,
                        weights: Optional[torch.Tensor] = None,
                        search_iters: int = 50) -> PointStats:
    """Perplexity calibration against the kNN distances only — O(N·k)."""
    n = knn_dist.shape[0]
    neg_d = -(knn_dist.to(torch.float32) ** 2)              # (N, k)
    beta = _beta_search(neg_d, _target_entropy(perplexity, knn_dist.device),
                        search_iters)
    logits = neg_d * beta[:, None]
    shift = logits.max(1).values
    zp = torch.exp(logits - shift[:, None]).sum(1)
    return PointStats(beta=beta, shift=shift, zp=zp,
                      w=_point_mass(weights, n, knn_dist.device))


@spans.spanned("affinity")
def sparse_p_from_knn(knn_idx: torch.Tensor, knn_dist: torch.Tensor,
                      perplexity: float,
                      weights: Optional[torch.Tensor] = None,
                      search_iters: int = 50) -> SparseP:
    """The symmetrized weighted COO P of a kNN graph (Σ val = 1)."""
    n, k = knn_idx.shape
    stats = calibrate_stats_knn(knn_dist, perplexity, weights=weights,
                                search_iters=search_iters)
    neg_d = -(knn_dist.to(torch.float32) ** 2)
    pc = torch.exp(neg_d * stats.beta[:, None] - stats.shift[:, None]) \
        / stats.zp[:, None]                                  # (N, k)
    c = 0.5 * (stats.w[:, None] * pc).reshape(-1)
    del pc
    rows = torch.arange(n, device=knn_idx.device).repeat_interleave(k)
    cols = knn_idx.reshape(-1).to(torch.int64)
    src, dst = torch.cat([rows, cols]), torch.cat([cols, rows])
    del rows, cols
    src, dst, val = coo.dedupe_edges(src, dst, torch.cat([c, c]))
    return SparseP(src=src, dst=dst, val=val,
                   bounds=coo.row_bounds(src, n))


def build_sparse_p(x: torch.Tensor, perplexity: float,
                   k: Optional[int] = None,
                   weights: Optional[torch.Tensor] = None,
                   search_iters: int = 50, block: int = 512,
                   mesh=None, method: str = "exact", ann=None,
                   ann_draws=None) -> SparseP:
    """kNN graph + kNN calibration + symmetrized COO P: the sparse
    backend's one-time setup.  ``ann_draws`` (``ann.AnnDraws``) replaces
    the approximate build's own draws."""
    from repro_torch.core import neighbors      # neighbors imports this
    n = x.shape[0]
    if k is None:
        k = max(8, int(round(3.0 * perplexity)))
    k = min(k, n - 1)
    idx, dist = neighbors.knn_graph(x, k, block=block, mesh=mesh,
                                    method=method, ann=ann,
                                    ann_draws=ann_draws)
    return sparse_p_from_knn(idx, dist, perplexity, weights=weights,
                             search_iters=search_iters)


def _cic_weights(y: torch.Tensor, grid_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cloud-in-cell cells (N, 2) int32 in [0, G−2], fractional offsets
    (N, 2) and the spacing h: the grid covers the bounding box with one
    spare cell on every side, square cells."""
    g = grid_size
    lo = y.min(0).values
    span = (y.max(0).values - lo).max().clamp(min=1e-9)
    h = span / (g - 3)
    u = (y - lo[None, :]) / h + 1.0                          # ∈ [1, g−2]
    i0 = torch.floor(u).to(torch.int32).clamp_(0, g - 2)
    return i0, u - i0, h


def _grid_convolve(grid: torch.Tensor, g: int, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convolve the splatted (3, G, G) masses with (1+r²)⁻² and (1+r²)⁻¹
    on the circulant-embedded 2G×2G domain.  Returns (conv1 (3, G, G),
    conv0 (G, G))."""
    idx = torch.arange(2 * g, device=grid.device)
    off = torch.where(idx <= g, idx, idx - 2 * g).to(torch.float32) * h
    r2 = off[:, None] ** 2 + off[None, :] ** 2
    k0 = 1.0 / (1.0 + r2)                                    # → Z
    k1 = k0 * k0                                             # → force
    pad = grid.new_zeros((grid.shape[0], 2 * g, 2 * g))
    pad[:, :g, :g] = grid
    mf = torch.fft.rfft2(pad)
    conv1 = torch.fft.irfft2(mf * torch.fft.rfft2(k1)[None],
                             s=(2 * g, 2 * g))[:, :g, :g]
    conv0 = torch.fft.irfft2(mf[0] * torch.fft.rfft2(k0),
                             s=(2 * g, 2 * g))[:g, :g]
    return conv1, conv0


def fft_repulsion(y: torch.Tensor, grid_size: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs repulsive field and Z by one particle-mesh pass:
    rep_i = Σ_j (1+|y_i−y_j|²)⁻² (y_i − y_j),  z = Σ_{i≠j} (1+|y_i−y_j|²)⁻¹.
    Splat (1, y_x, y_y) (K2), convolve, gather conv1's 3 channels and
    conv0 (K3); the self terms cancel in rep and are subtracted from z."""
    n, g = y.shape[0], grid_size
    y = y.to(torch.float32)
    i0, f, h = _cic_weights(y, g)
    masses = torch.stack([torch.ones_like(y[:, 0]), y[:, 0], y[:, 1]], 1)
    grid = cic.cic_splat(i0, f, masses, g)
    conv1, conv0 = _grid_convolve(grid, g, h)
    # channels-last (G, G, 4), the layout K3 reads, as a (4, G, G) view
    fields = torch.stack([conv1[0], conv1[1], conv1[2], conv0], -1)
    got = cic.cic_gather(fields.permute(2, 0, 1), i0, f)            # (N, 4)
    z = (got[:, 3].sum() - n).clamp(min=1e-12)
    return got[:, :1] * y - got[:, 1:3], z


def sparse_grad(y: torch.Tensor, sp: SparseP, exaggeration: float = 1.0,
                grid_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sparse gradient: (grad (N, 2), KL of the exaggerated sparse P
    against Q), attraction on the kNN support, Q-sum on the grid."""
    diff = y[sp.src] - y[sp.dst]
    num = 1.0 / (1.0 + (diff * diff).sum(1))                 # (E,)
    pe = exaggeration * sp.val
    att = coo.segment_reduce((pe * num)[:, None] * diff, sp.bounds)
    rep, z = fft_repulsion(y, grid_size)
    grad = 4.0 * (att - rep / z)
    # KL = Σ pe log pe − Σ pe log num + (Σ pe)·log Z,  Σ pe = exag
    a = torch.where(pe > 0, pe * torch.log(pe.clamp(min=1e-37)), 0.0).sum()
    b = (pe * torch.log(num.clamp(min=1e-37))).sum()
    return grad, a - b + exaggeration * torch.log(z)


# ------------------------------------------------------------- mesh sharding
# Row-block-sharded sparse backend over a 1-D mesh (core.mesh).  Rank s owns
# global rows [s·rows_per, (s+1)·rows_per) of the optimizer state and the
# matching contiguous slice of the src-sorted edge list: P only deposits
# into src rows (the symmetrized COO carries both directions), so tSNE
# needs no dst-side exchange at all.

class SparseBlock(NamedTuple):
    """One rank's row block of a :class:`SparseP`: the block's edges in
    their src-sorted order, padded to the widest block's count ``Ep`` by
    repeating the block's last edge (edge 0 for a block without edges)
    with value 0, and local CSR bounds over its ``rows_per`` rows.  The
    bounds end at the block's own edges: the padding belongs to no row."""
    src: torch.Tensor     # (Ep,) int64 global ids
    dst: torch.Tensor     # (Ep,) int64 global ids
    val: torch.Tensor     # (Ep,) float32, 0 on padded slots
    bounds: torch.Tensor  # (rows_per+1,) int32, over the local rows
    row_offset: int       # first global row of the block


class ShardedSparseP(NamedTuple):
    """``SparseP`` laid out for every block of a 1-D mesh on the host
    (``coo.ShardedEdgeLayout``) with the matching (S, Ep) values, zero on
    padded slots: the reference's layout, used to check the device cut."""
    layout: coo.ShardedEdgeLayout
    val: torch.Tensor     # (S, Ep) float32

    def block(self, s: int, device) -> SparseBlock:
        """Block ``s`` as a :class:`SparseBlock` on ``device``."""
        eb = self.layout.block(s, device)
        return SparseBlock(src=eb.src, dst=eb.dst, val=self.val[s].to(device),
                           bounds=eb.src_bounds, row_offset=eb.row_offset)


def shard_sparse_p(sp: SparseP, n: int, n_shards: int) -> ShardedSparseP:
    """Every row block's edge slice, built on the host in numpy (the
    reference's setup; the mesh run cuts its own block on the device with
    :func:`sparse_p_block` instead)."""
    layout = coo.shard_edge_layout(sp.src.cpu().numpy(), sp.dst.cpu().numpy(),
                                   n, n_shards)
    return ShardedSparseP(layout=layout,
                          val=coo.shard_payload(layout, sp.val.cpu()))


def sparse_p_block(sp: SparseP, n: int, n_shards: int, s: int
                   ) -> SparseBlock:
    """Block ``s`` of ``n_shards`` cut from the src-sorted ``sp`` on its
    device: its live rows [r0, r1) (within [s·rows_per, (s+1)·rows_per)
    and below n) are the contiguous edges ``sp.bounds[r0]:sp.bounds[r1]``
    and the local bounds ``sp.bounds[r0:r1+1] − sp.bounds[r0]``, held at
    their last value over the padded rows.  One host read of the S + 1
    block boundaries sizes the padding.  The result equals
    ``shard_sparse_p(sp, n, n_shards).block(s)`` but for the bounds: the
    host layout hands the padding to the block's last row, here it
    belongs to no row.  Its value is 0, so the row sums are the same, but
    K1 gives a row one group of lanes, and a block of fewer edges than
    the widest would leave one group to walk the whole padding."""
    dev = sp.src.device
    rows_per = -(-n // n_shards)
    cuts = (torch.arange(n_shards + 1, device=dev) * rows_per).clamp_(max=n)
    eb = sp.bounds[cuts].tolist()
    ep = max(1, max(b - a for a, b in zip(eb[:-1], eb[1:])))
    lo, hi = eb[s], eb[s + 1]
    last = hi - 1 if hi > lo else 0
    pad = ep - (hi - lo)

    def cut(t):
        return torch.cat([t[lo:hi], t[last:last + 1].expand(pad)])
    r0 = min(s * rows_per, n)
    b = sp.bounds[r0:min(r0 + rows_per, n) + 1] - lo
    bounds = torch.cat([b, b[-1:].expand(rows_per + 1 - b.shape[0])]).to(
        torch.int32)
    return SparseBlock(src=cut(sp.src), dst=cut(sp.dst),
                       val=torch.cat([sp.val[lo:hi], sp.val.new_zeros(pad)]),
                       bounds=bounds, row_offset=s * rows_per)


def _live_rows(blk: SparseBlock, n: int) -> torch.Tensor:
    """(rows_per,) bool: the block's rows below ``n``."""
    rows_per = blk.bounds.shape[0] - 1
    return blk.row_offset + torch.arange(rows_per,
                                         device=blk.bounds.device) < n


def _fft_repulsion_shard(y_blk: torch.Tensor, live_blk: torch.Tensor,
                         y_full: torch.Tensor, n: int, grid_size: int,
                         mesh, axis: str, ride: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """:func:`fft_repulsion` for one rank's row block.  The grid's
    geometry comes from the live rows of the gathered ``y_full`` (the
    same on every rank); the rank splats its own rows (K2), ONE
    all-reduce sums the grid together with ``ride`` (a few partial sums
    that need the same reduction), the FFT runs replicated and the rank
    gathers its rows back (K3); Z is an all-reduce of Σ φ₀·mass, minus n.
    Returns (rep (rows_per, 2), z, the summed ``ride``)."""
    g = grid_size
    live_full = (torch.arange(y_full.shape[0], device=y_full.device)
                 < n)[:, None]
    lo = torch.where(live_full, y_full, math.inf).min(0).values
    hi = torch.where(live_full, y_full, -math.inf).max(0).values
    span = (hi - lo).max().clamp(min=1e-9)
    h = span / (g - 3)
    # padded rows carry no mass; they sit on a valid cell
    y_blk = torch.where(live_blk[:, None], y_blk.to(torch.float32), lo)
    u = (y_blk - lo[None, :]) / h + 1.0
    i0 = torch.floor(u).to(torch.int32).clamp_(0, g - 2)
    f = u - i0
    mass = live_blk.to(torch.float32)
    masses = torch.stack([mass, y_blk[:, 0] * mass, y_blk[:, 1] * mass], 1)
    grid = cic.cic_splat(i0, f, masses, g)
    tot = mesh_mod.all_reduce(torch.cat([grid.reshape(-1), ride]), mesh,
                              axis)
    grid = tot[:grid.numel()].reshape(grid.shape)
    conv1, conv0 = _grid_convolve(grid, g, h)
    fields = torch.stack([conv1[0], conv1[1], conv1[2], conv0], -1)
    got = cic.cic_gather(fields.permute(2, 0, 1), i0, f)            # (B, 4)
    z = mesh_mod.all_reduce((got[:, 3] * mass).sum(), mesh, axis)
    z = (z - n).clamp(min=1e-12)
    return got[:, :1] * y_blk - got[:, 1:3], z, tot[grid.numel():]


def sparse_grad_shard(y_blk: torch.Tensor, blk: SparseBlock,
                      y_full: torch.Tensor, exaggeration: float,
                      grid_size: int, mesh, axis: str, n: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sparse_grad` for one rank: ``y_blk`` (rows_per, 2) its
    rows, ``blk`` its :class:`SparseBlock`, ``y_full`` the all-gathered
    (n_padded, 2) positions.  The attraction is a local K1 over the
    block's edges; the KL's two partials ride with the grid's
    all-reduce.  Returns (grad (rows_per, 2), exactly 0 on padded rows;
    the KL, the same on every rank)."""
    diff = y_full[blk.src] - y_full[blk.dst]
    num = 1.0 / (1.0 + (diff * diff).sum(1))                 # (Ep,)
    pe = exaggeration * blk.val                              # 0 on padding
    att = coo.segment_reduce((pe * num)[:, None] * diff, blk.bounds)
    a = torch.where(pe > 0, pe * torch.log(pe.clamp(min=1e-37)), 0.0).sum()
    b = (pe * torch.log(num.clamp(min=1e-37))).sum()
    live = _live_rows(blk, n)
    rep, z, ab = _fft_repulsion_shard(y_blk, live, y_full, n, grid_size,
                                      mesh, axis, torch.stack([a, b]))
    grad = torch.where(live[:, None], 4.0 * (att - rep / z), 0.0)
    return grad, ab[0] - ab[1] + exaggeration * torch.log(z)


# ----------------------------------------------------------- exact backends

def kl_divergence(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    num = 1.0 / (1.0 + pairwise_sq_dists(y))
    num.fill_diagonal_(0.0)
    q = (num / num.sum()).clamp(min=1e-12)
    return (p * (torch.log(p) - torch.log(q))).sum()


def _grad_and_kl(p: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact gradient (matmul form) + KL — the dense backend."""
    num = 1.0 / (1.0 + pairwise_sq_dists(y))                 # (N, N)
    num.fill_diagonal_(0.0)
    z = num.sum()
    q = (num / z).clamp(min=1e-12)
    pq = (p - q) * num
    grad = 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)
    return grad, (p * (torch.log(p) - torch.log(q))).sum()


def embedding_grad(x: torch.Tensor, y: torch.Tensor, stats: PointStats,
                   exaggeration: float = 1.0, *, backend: str = "tiled",
                   block: int = 512, order: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exact gradient on any exact backend: (grad (N, dims), KL of the
    exaggerated P against the current Q).  ``order``: the "pallas"
    backend's row order (``fused.locality_order(x)``, computed per call
    when None)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend == "sparse":
        raise ValueError(
            "the sparse backend is calibrated from the kNN graph, not "
            "PointStats — use build_sparse_p(...) once, then sparse_grad()")
    if backend == "dense":
        return _grad_and_kl(p_from_stats(x, stats) * exaggeration, y)
    block = min(block, x.shape[0])
    if backend == "pallas":
        return fused.tsne_step_fused(
            x, y, stats.beta, stats.zp, shift=stats.shift, weights=stats.w,
            exaggeration=exaggeration, block=block, return_kl=True,
            order=order)
    # tiled: the fused step's plain twins, streamed in ``block`` rows (the
    # reference's _tiled_grad_kl: Z first, then forces and KL partials)
    st = torch.stack([stats.beta, stats.shift, stats.zp, stats.w], 1)
    z = fused.tsne_z_torch(y, rows=block)
    f, kl_parts = fused.tsne_forces_torch(x, y, st, z, exaggeration,
                                          rows=block)
    return f, fused.step_kl(kl_parts, z, exaggeration)


# ---------------------------------------------------------------- optimizer

class TsneState(NamedTuple):
    y: torch.Tensor
    velocity: torch.Tensor
    gains: torch.Tensor


def _momentum_update(state: TsneState, grad: torch.Tensor, mom: float,
                     cfg: TsneConfig) -> TsneState:
    """One momentum + per-parameter-gains update, recentered."""
    same_sign = torch.sign(grad) == torch.sign(state.velocity)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = gains.clamp(min=cfg.min_gain)
    vel = mom * state.velocity - cfg.learning_rate * gains * grad
    y = state.y + vel
    y = y - y.mean(0, keepdim=True)
    return TsneState(y, vel, gains)


def _momentum_update_shard(state: TsneState, grad: torch.Tensor, mom: float,
                           cfg: TsneConfig, mesh, axis: str,
                           live_blk: torch.Tensor, n: int) -> TsneState:
    """:func:`_momentum_update` on a row block: the recentering mean is an
    all-reduce of the live rows' partial sums."""
    same_sign = torch.sign(grad) == torch.sign(state.velocity)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = gains.clamp(min=cfg.min_gain)
    vel = mom * state.velocity - cfg.learning_rate * gains * grad
    y = state.y + vel
    total = mesh_mod.all_reduce(
        torch.where(live_blk[:, None], y, 0.0).sum(0), mesh, axis)
    return TsneState(y - (total / n)[None, :], vel, gains)


def _phase(i: int, cfg: TsneConfig) -> Tuple[float, float]:
    """Schedule scalars (exaggeration, momentum) at iteration i."""
    exag = cfg.early_exaggeration if i < cfg.exaggeration_iters else 1.0
    mom = cfg.momentum_start if i < cfg.momentum_switch \
        else cfg.momentum_final
    return exag, mom


def _grid_for_span(span: float, g: int, cfg: TsneConfig) -> int:
    """Smallest doubling of the current G that keeps the cell spacing
    h = span/(G−3) at or under ``cfg.grid_interval``, capped."""
    while g < cfg.grid_max and span / (g - 3) > cfg.grid_interval:
        g *= 2
    return g


GradFn = Callable[[torch.Tensor, float, int],
                  Tuple[torch.Tensor, torch.Tensor]]


def _span(y: torch.Tensor) -> float:
    """The embedding's larger side, read back to the host."""
    return float((y.max(0).values - y.min(0).values).max())


@spans.spanned("optimize")
def _optimize(y0: torch.Tensor, grad_fn: GradFn, cfg: TsneConfig,
              adaptive: bool, update=None, span=_span
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The momentum/gains loop; with ``adaptive`` it runs in stages of
    ``cfg.adaptive_interval`` iterations and reads the span back after
    each stage to grow G.  ``update(state, grad, mom)`` and ``span(y)``
    replace the single-device update and span (the mesh path's)."""
    if update is None:
        def update(st, grad, mom):
            return _momentum_update(st, grad, mom, cfg)
    state = TsneState(y=y0, velocity=torch.zeros_like(y0),
                      gains=torch.ones_like(y0))
    kls = torch.zeros((cfg.n_iter,), device=y0.device)
    g = cfg.grid_size
    stage = cfg.adaptive_interval if adaptive else cfg.n_iter
    it = 0
    while it < cfg.n_iter:
        end = min(it + stage, cfg.n_iter)
        for i in range(it, end):
            exag, mom = _phase(i, cfg)
            grad, kl = grad_fn(state.y, exag, g)
            state = update(state, grad, mom)
            kls[i] = kl
        it = end
        if adaptive and it < cfg.n_iter:
            g = _grid_for_span(span(state.y), g, cfg)
    return state.y, kls


def _run_tsne_sparse_mesh(x: torch.Tensor, y0: torch.Tensor, cfg: TsneConfig,
                          weights: Optional[torch.Tensor], mesh, ann_draws
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse optimizer over the ranks of a 1-D mesh (fixed or
    adaptive G): the sharded kNN build and the replicated P, this rank's
    block cut on the device, then the loop on the block.  ``y0`` is the
    whole (N, 2) init, the same on every rank.  Returns the whole
    embedding and KL trace on every rank."""
    axis = mesh_mod.mesh_axis(mesh)
    n_shards = mesh_mod.axis_size(mesh, axis)
    n = x.shape[0]
    sp = build_sparse_p(x, cfg.perplexity, k=cfg.knn or None,
                        weights=weights, search_iters=cfg.sigma_search_iters,
                        block=cfg.block, mesh=mesh, method=cfg.knn_method,
                        ann=cfg.ann, ann_draws=ann_draws)
    blk = sparse_p_block(sp, n, n_shards, mesh.get_local_rank(axis))
    del sp
    rows_per, n_pad = mesh_mod.row_block(n, n_shards)
    live = _live_rows(blk, n)
    y_blk = torch.cat([y0, y0.new_zeros((n_pad - n, y0.shape[1]))])[
        blk.row_offset:blk.row_offset + rows_per].clone()

    def grad_fn(y, exag, g):
        y_full = mesh_mod.all_gather(y, mesh, axis)
        return sparse_grad_shard(y, blk, y_full, exag, g, mesh, axis, n)

    def update(st, grad, mom):
        return _momentum_update_shard(st, grad, mom, cfg, mesh, axis, live, n)

    def span(y):
        lo = torch.where(live[:, None], y, math.inf).min(0).values
        hi = torch.where(live[:, None], y, -math.inf).max(0).values
        ext = mesh_mod.all_reduce(torch.cat([hi, -lo]), mesh, axis, "max")
        return float((ext[:2] + ext[2:]).max())

    y_blk, kls = _optimize(y_blk, grad_fn, cfg, cfg.grid_interval > 0,
                           update=update, span=span)
    return mesh_mod.all_gather(y_blk, mesh, axis)[:n], kls


def run_tsne(x: torch.Tensor, cfg: TsneConfig,
             weights: Optional[torch.Tensor] = None,
             backend: Optional[str] = None, mesh=None,
             init: Optional[torch.Tensor] = None, *,
             generator: Optional[torch.Generator] = None,
             ann_draws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full tSNE on ``x``'s device: (embedding (N, dims), KL trace
    (n_iter,)).  ``backend`` overrides ``cfg.backend``.  ``init`` seeds
    the optimizer at given (N, dims) coordinates instead of the
    1e-4·normal cold start drawn from ``generator``; with ``n_iter == 0``
    the init comes back bit for bit.  ``ann_draws`` goes to the sparse
    backend's approximate kNN build.  ``mesh`` (the sparse backend only)
    shards the run over the ranks of a 1-D mesh: every rank passes the
    same ``x`` and draws the same init, and gets the whole embedding and
    KL trace (see the module docstring)."""
    backend = backend or cfg.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend == "sparse" and cfg.dims != 2:
        raise ValueError(
            f"sparse backend splats onto a 2D grid; got dims={cfg.dims}")
    if cfg.cic not in CIC_PATHS:
        raise ValueError(f"unknown cic {cfg.cic!r}; want one of {CIC_PATHS}")
    init = validate_init(init, x.shape[0], cfg.dims)
    n = x.shape[0]
    if init is not None:
        y0 = init.to(x.device)
    else:
        y0 = 1e-4 * torch.randn((n, cfg.dims), generator=generator,
                                device=x.device)
    if cfg.n_iter == 0:
        return y0, torch.zeros((0,), device=x.device)
    mesh = mesh_mod.resolve_mesh(mesh)
    if mesh is not None:
        if backend != "sparse":
            raise ValueError(
                f"mesh-parallel tSNE needs backend='sparse'; got {backend!r}")
        return _run_tsne_sparse_mesh(x, y0, cfg, weights, mesh, ann_draws)
    if backend == "sparse":
        sp = build_sparse_p(x, cfg.perplexity, k=cfg.knn or None,
                            weights=weights,
                            search_iters=cfg.sigma_search_iters,
                            block=cfg.block, method=cfg.knn_method,
                            ann=cfg.ann, ann_draws=ann_draws)

        def grad_fn(y, exag, g):
            return sparse_grad(y, sp, exag, grid_size=g)
        return _optimize(y0, grad_fn, cfg, adaptive=cfg.grid_interval > 0)
    with spans.span("affinity"):
        stats = calibrate_stats(x, cfg.perplexity, weights=weights,
                                search_iters=cfg.sigma_search_iters,
                                block=cfg.block)
        p = p_from_stats(x, stats) if backend == "dense" else None
        # the fused kernels' row order, once a run
        order = fused.locality_order(x) if backend == "pallas" else None
    if backend == "dense":
        def grad_fn(y, exag, g):
            return _grad_and_kl(p * exag, y)
    else:
        def grad_fn(y, exag, g):
            return embedding_grad(x, y, stats, exag, backend=backend,
                                  block=cfg.block, order=order)
    return _optimize(y0, grad_fn, cfg, adaptive=False)
