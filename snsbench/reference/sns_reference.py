"""Plain reference of one Sketch-and-Scale map, in torch, for the benchmark.

It imports nothing of the program under test.  Each stage is written out
from the algorithm's definition (the paper's sketch, heavy hitters and
replicas; UMAP's fuzzy set and epoch; sparse tSNE's P, particle-mesh
gradient and momentum update) and takes only the benchmark's own inputs,
or a state of the program that it judges, never a table or a draw the
program made.

Every stage takes ``dt``, the precision it computes in.  ``float32`` is
the reference; ``bfloat16`` is the control, the same arithmetic with each
stage's inputs and outputs rounded to bfloat16 (FFTs and sums then run on
the rounded values in float32).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

M32 = (1 << 32) - 1
ROW_BLOCK = 1 << 22          # points a block when quantizing


def rnd(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dt`` and back: the identity at float32."""
    if dt == torch.float32 or not t.is_floating_point():
        return t
    return t.to(dt).to(t.dtype)


# ------------------------------------------------------------------ sketch

class Grid(NamedTuple):
    lo: np.ndarray           # (D,) float32, padded lower corner
    hi: np.ndarray           # (D,) float32, padded upper corner
    bins: int
    bits: int                # bits a coordinate takes in the packed key

    @property
    def cell(self) -> np.ndarray:
        return ((self.hi - self.lo) / np.float32(self.bins)).astype(
            np.float32)

    @property
    def inv(self) -> np.ndarray:
        return (np.float32(self.bins) / (self.hi - self.lo)).astype(
            np.float32)


def fit_grid(points: torch.Tensor, bins: int, dt: torch.dtype,
             pad: float = 1e-3) -> Grid:
    """The enclosing box of the points, widened by ``pad`` of its span on
    each side, with ``bins`` cells an axis (float32 arithmetic)."""
    lo0 = rnd(points.amin(0), dt).cpu().numpy().astype(np.float32)
    hi0 = rnd(points.amax(0), dt).cpu().numpy().astype(np.float32)
    span = np.maximum(hi0 - lo0, np.float32(1e-12)).astype(np.float32)
    lo = (lo0 - np.float32(pad) * span).astype(np.float32)
    hi = (hi0 + np.float32(pad) * span).astype(np.float32)
    return Grid(lo, hi, int(bins), max(1, math.ceil(math.log2(bins))))


def cell_keys(grid: Grid, points: torch.Tensor, dt: torch.dtype
              ) -> torch.Tensor:
    """(N,) int64 key of each point's cell: coordinate i of the cell,
    floor((x − lo)·bins/(hi − lo)) clamped to [0, bins), in bits
    [bits·(D−1−i), bits·(D−i)) of the key."""
    dev, d = points.device, points.shape[1]
    lo = torch.as_tensor(grid.lo, device=dev).to(dt)
    inv = torch.as_tensor(grid.inv, device=dev).to(dt)
    shifts = torch.tensor([grid.bits * (d - 1 - i) for i in range(d)],
                          device=dev)
    out = torch.empty(points.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, points.shape[0], ROW_BLOCK):
        x = points[s:s + ROW_BLOCK].to(dt)
        c = torch.floor((x - lo) * inv).clamp_(0, grid.bins - 1).long()
        out[s:s + ROW_BLOCK] = (c << shifts).sum(1)
    return out


def _mul_u32(a_hi: torch.Tensor, a_lo: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a · x) mod 2⁶⁴ as 32-bit halves, for a 64-bit a = (a_hi, a_lo)
    and a 32-bit x; every product stays below 2⁴⁹ in int64."""
    xl, xh = x & 0xFFFF, x >> 16
    p1, p2 = a_lo * xl, a_lo * xh
    lo = (p1 & M32) + ((p2 & 0xFFFF) << 16)
    hi = (p1 >> 32) + (p2 >> 16) + (lo >> 32)
    q = (a_hi * xl + (((a_hi * xh) & 0xFFFF) << 16)) & M32
    return (hi + q) & M32, lo & M32


def _add(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def hash_row(params: torch.Tensor, r: int, keys: torch.Tensor,
             log2_cols: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket in [0, 2^log2_cols) and sign ±1 of each 64-bit key under
    hash r: Thorup's vector multiply-shift, the top bits of
    (a1·key_hi + a2·key_lo + b) mod 2⁶⁴.  ``params`` is (6, R) int64
    holding the uint32 limbs a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo."""
    a1h, a1l, a2h, a2l, bh, bl = (params[i, r] for i in range(6))
    t = _add(_mul_u32(a1h, a1l, keys >> 32), _mul_u32(a2h, a2l, keys & M32))
    hi, _ = _add(t, (bh, bl))
    return hi >> (32 - log2_cols), 1 - 2 * (hi >> 31)


class HeavyHitters(NamedTuple):
    keys: torch.Tensor       # (K,) int64, count-descending
    count: torch.Tensor      # (K,) float32 sketch estimate, 0 when masked
    mask: torch.Tensor       # (K,) bool
    cells: int               # distinct occupied cells of the points
    table_cells: int         # distinct (row, bucket) the update touches
    pool_cells: int          # distinct (row, bucket) the estimate reads


def _top_cells(keys: torch.Tensor, pool: int) -> torch.Tensor:
    """The ``pool`` most frequent of ``keys`` (smaller key first among
    equal counts)."""
    cells, counts = torch.unique(keys, sorted=True, return_counts=True)
    return cells[torch.sort(counts, descending=True, stable=True)[1][:pool]]


def heavy_hitters(points: torch.Tensor, bins: int, params: torch.Tensor,
                  log2_cols: int, top_k: int, dt: torch.dtype
                  ) -> Tuple[Grid, HeavyHitters]:
    """Grid → exact cell counts → the Count Sketch of those counts →
    the 2·top_k most frequent cells (count-descending, smaller key first
    among equal counts) → the top_k of them by sketch estimate (the
    median over rows of sign·table; smaller key first among ties)."""
    grid = fit_grid(points, bins, dt)
    all_keys = cell_keys(grid, points, dt)
    keys, counts = torch.unique(all_keys, sorted=True, return_counts=True)
    rows, dev = params.shape[1], points.device
    table = torch.zeros((rows, 1 << log2_cols), dtype=torch.int64,
                        device=dev)
    touched = 0
    for r in range(rows):
        b, s = hash_row(params, r, keys, log2_cols)
        table[r].index_add_(0, b, s * counts)
        touched += int(torch.unique(b).numel())
    cand = torch.sort(_top_cells(all_keys, min(2 * top_k,
                                               points.shape[0])))[0]
    del all_keys
    est = torch.empty((rows, cand.shape[0]), dtype=torch.float64, device=dev)
    pool_touched = 0
    for r in range(rows):
        b, s = hash_row(params, r, cand, log2_cols)
        est[r] = (s * table[r, b]).double()
        pool_touched += int(torch.unique(b).numel())
    srt = torch.sort(est, dim=0)[0]
    med = ((srt[(rows - 1) // 2] + srt[rows // 2]) * 0.5).float()
    med = rnd(med, dt)
    top = torch.sort(med, descending=True, stable=True)[1][:top_k]
    k_est = med[top]
    mask = torch.isfinite(k_est) & (k_est > 0)
    return grid, HeavyHitters(cand[top], torch.where(mask, k_est, 0.0), mask,
                              int(keys.numel()), touched, pool_touched)


# ---------------------------------------------------------------- replicas

class Reps(NamedTuple):
    points: torch.Tensor     # (K·max_replicas, D) float32
    weight: torch.Tensor     # (K·max_replicas,) float32, 0 on dead slots
    mask: torch.Tensor       # (K·max_replicas,) bool


def representatives(grid: Grid, hh: HeavyHitters, jitter: torch.Tensor,
                    max_replicas: int, dt: torch.dtype) -> Reps:
    """Each heavy cell's center plus ``jitter`` (cell units) for its
    1 + ⌊log₂(count / least count)⌋ replicas (at most ``max_replicas``),
    each carrying count / replicas."""
    dev = hh.keys.device
    d = grid.lo.shape[0]
    shifts = torch.tensor([grid.bits * (d - 1 - i) for i in range(d)],
                          device=dev)
    coords = (hh.keys[:, None] >> shifts) & ((1 << grid.bits) - 1)
    cell = torch.as_tensor(grid.cell, device=dev)
    lo = torch.as_tensor(grid.lo, device=dev)
    centers = lo + (coords.float() + 0.5) * cell
    f = hh.count.clamp(min=1e-9)
    f_min = torch.where(hh.mask, f, float("inf")).min()
    two = torch.log(torch.tensor(2.0, device=dev))
    n = 1 + torch.floor(torch.log((f / f_min).clamp(min=1.0)) / two).long()
    n = torch.where(hh.mask, n.clamp(1, max_replicas), 0)
    pts = rnd(centers[:, None, :] + rnd(jitter, dt) * cell, dt)
    live = torch.arange(max_replicas, device=dev)[None, :] < n[:, None]
    w = hh.count[:, None] / n[:, None].float().clamp(min=1.0)
    return Reps(pts.reshape(-1, d), torch.where(live, w, 0.0).reshape(-1),
                live.reshape(-1))


# -------------------------------------------------------------------- kNN

def knn_rows(x: torch.Tensor, rows: torch.Tensor, k: int, dt: torch.dtype,
             block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours of ``x[rows]`` in ``x`` (self left out),
    distances from the coordinate differences (no Gram identity):
    (idx (S, k) int64, dist (S, k) float32), nearest first."""
    xr = rnd(x, dt)
    idx_out, dist_out = [], []
    for s in range(0, rows.shape[0], block):
        r = rows[s:s + block]
        d = torch.cdist(xr[r], xr, compute_mode="donot_use_mm_for_euclid_dist")
        d[torch.arange(r.shape[0], device=x.device), r] = float("inf")
        top, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        idx_out.append(idx)
        dist_out.append(rnd(top, dt))
    return torch.cat(idx_out), torch.cat(dist_out)


def pair_dists(x: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor
               ) -> torch.Tensor:
    """|x[rows[i]] − x[idx[i, j]]| from the differences, float32."""
    return (x[rows][:, None, :] - x[idx]).norm(dim=2)


# ------------------------------------------------------------------- UMAP

def umap_ab(spread: float, min_dist: float) -> Tuple[float, float]:
    """(a, b) of UMAP's membership curve 1/(1 + a·d^{2b}), least-squares
    fitted to 1 below min_dist and exp(−(d − min_dist)/spread) above, on
    300 points of [0, 3·spread] (McInnes et al. 2018, umap-learn)."""
    from scipy.optimize import curve_fit
    xs = np.linspace(0, 3.0 * spread, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xs, ys, p0=(1.0, 1.0), maxfev=10_000)
    return float(a), float(b)


def fuzzy_set(idx: torch.Tensor, dist: torch.Tensor, weights: torch.Tensor,
              search_iters: int, dt: torch.dtype) -> torch.Tensor:
    """UMAP's symmetrized memberships on the kNN edges (i, idx[i, j]),
    row-major: exp(−(d − ρ_i)/σ_i), σ_i bisected so a row sums to
    log₂ k, scaled by the point's weight / mean weight and capped at 1,
    then a ⊕ a' = a + a' − a·a' with the reverse edge's (0 if absent)."""
    n, k = idx.shape
    dev = dist.device
    dist = rnd(dist, dt)
    rho = dist[:, 0]
    target = torch.log(torch.tensor(float(k))) / torch.log(torch.tensor(2.0))
    target = target.to(dev)
    lo = torch.full((n,), 1e-6, device=dev)
    hi = torch.full((n,), 1e6, device=dev)
    d = (dist - rho[:, None]).clamp(min=0.0)
    for _ in range(search_iters):
        mid = 0.5 * (lo + hi)
        big = torch.exp(-d / mid[:, None]).sum(1) > target
        lo, hi = torch.where(big, lo, mid), torch.where(big, mid, hi)
    memb = torch.exp(-d / (0.5 * (lo + hi))[:, None])
    memb = rnd((memb * (weights / weights.mean())[:, None]).clamp(max=1.0),
               dt).reshape(-1)
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = idx.reshape(-1)
    key, order = torch.sort(rows * n + cols)
    pos = torch.searchsorted(key, cols * n + rows).clamp_(max=key.numel() - 1)
    rev = torch.where(key[pos] == cols * n + rows, memb[order[pos]], 0.0)
    return rnd(memb + rev - memb * rev, dt)


def umap_epoch(y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               memb_n: torch.Tensor, neg: torch.Tensor, a: float, b: float,
               dt: torch.dtype) -> torch.Tensor:
    """One epoch's per-point move: for each edge the clipped attraction
    (−2ab·d^{2(b−1)}/(1 + a·d^{2b})·(y_s − y_d), into s and reversed into
    d) and the clipped repulsion of its negative samples (2b/((0.001 +
    d²)(1 + a·d^{2b}))·(y_s − y_n), into s; samples equal to s or d left
    out), each times the edge's normalized membership.  Sums in float64."""
    y = rnd(y, dt)
    ys, yd = y[src], y[dst]
    diff = ys - yd
    d2 = (diff * diff).sum(1)
    coef = (-2.0 * a * b * d2 ** (b - 1.0)) / (1.0 + a * d2 ** b)
    coef = torch.where(d2 > 0, coef, 0.0)
    att = rnd((coef[:, None] * diff).clamp(-4.0, 4.0) * memb_n[:, None], dt)
    ndiff = ys[:, None, :] - y[neg]
    dn2 = (ndiff * ndiff).sum(2)
    rcoef = (2.0 * b) / ((0.001 + dn2) * (1.0 + a * dn2 ** b))
    rep = (rcoef[..., None] * ndiff).clamp(-4.0, 4.0) * memb_n[:, None, None]
    ok = (neg != src[:, None]) & (neg != dst[:, None])
    rep = rnd(torch.where(ok[..., None], rep, 0.0).sum(1), dt)
    out = torch.zeros(y.shape, dtype=torch.float64, device=y.device)
    out.index_add_(0, src, (att + rep).double())
    out.index_add_(0, dst, -att.double())
    return rnd(out.float(), dt)


def umap_alpha(lr: float, i: int, n_epochs: int) -> float:
    """The learning rate of epoch i, lr·(1 − i/n_epochs) in float32."""
    return float(np.float32(lr) * (np.float32(1.0) - np.float32(i)
                                   / np.float32(n_epochs)))


# ------------------------------------------------------------------- tSNE

class SparseP(NamedTuple):
    src: torch.Tensor        # (E,) int64, sorted by (src, dst)
    dst: torch.Tensor
    val: torch.Tensor        # (E,) float32, a pair's total on its first slot


def sparse_p(idx: torch.Tensor, dist: torch.Tensor, weights: torch.Tensor,
             perplexity: float, search_iters: int, dt: torch.dtype
             ) -> SparseP:
    """tSNE's joint P on the kNN support: per row β bisected (doubling
    while unbounded) so the entropy of p(j|i) ∝ exp(−β·d²) over the
    row's neighbours is log(perplexity); P_ij = ½(w_i·p(j|i) + w_j·p(i|j))
    with w the normalized weights; a pair found twice is summed on its
    first slot of the (src, dst)-sorted list and 0 on the other."""
    n, k = idx.shape
    dev = idx.device
    neg_d = -(rnd(dist.float(), dt) ** 2)
    target = torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                    device=dev))
    beta = torch.ones((n,), device=dev)
    lo = torch.zeros((n,), device=dev)
    hi = torch.full((n,), math.inf, device=dev)
    for _ in range(search_iters):
        lg = neg_d * beta[:, None]
        lg = lg - lg.max(1, keepdim=True).values
        p = torch.exp(lg)
        ps = p.sum(1, keepdim=True)
        p = p / ps
        h = -torch.where(p > 0, p * (lg - torch.log(ps)), 0.0).sum(1)
        up = h > target
        lo = torch.where(up, beta, lo)
        hi = torch.where(up, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    lg = neg_d * beta[:, None]
    shift = lg.max(1).values
    zp = torch.exp(lg - shift[:, None]).sum(1)
    pc = torch.exp(lg - shift[:, None]) / zp[:, None]
    w = weights / weights.sum()
    c = rnd((0.5 * w[:, None] * pc).reshape(-1), dt)
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = idx.reshape(-1)
    key, order = torch.sort(torch.cat([rows * (1 << 32) + cols,
                                       cols * (1 << 32) + rows]), stable=True)
    v = torch.cat([c, c])[order]
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    run = torch.cumsum(head, 0) - 1
    tot = torch.zeros_like(v).index_add_(0, run, v)
    return SparseP(key >> 32, key & M32, torch.where(head, tot[run], 0.0))


def pm_repulsion(y: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_j (1+|y_i−y_j|²)⁻²(y_i−y_j) and Z = Σ_{i≠j} (1+|y_i−y_j|²)⁻¹ by
    one particle-mesh pass in float64: bilinear splat of (1, y) onto a
    G×G grid of square cells spanning the box with a spare cell a side,
    FFT convolution with (1+r²)⁻² and (1+r²)⁻¹ on the 2G×2G circulant,
    bilinear read back; the self terms cancel in the force and leave Z."""
    y = y.double()
    n = y.shape[0]
    lo = y.min(0).values
    span = (y.max(0).values - lo).max().clamp(min=1e-9)
    h = span / (g - 3)
    u = (y - lo) / h + 1.0
    i0 = torch.floor(u).clamp_(0, g - 2).long()
    f = u - i0
    mass = torch.stack([torch.ones_like(y[:, 0]), y[:, 0], y[:, 1]], 0)
    grid = torch.zeros((3, g * g), dtype=torch.float64, device=y.device)
    corners = [(dx, dy, (f[:, 0] if dx else 1 - f[:, 0])
                * (f[:, 1] if dy else 1 - f[:, 1]))
               for dx in (0, 1) for dy in (0, 1)]
    for dx, dy, w in corners:
        grid.index_add_(1, (i0[:, 0] + dx) * g + i0[:, 1] + dy, mass * w)
    ix = torch.arange(2 * g, device=y.device)
    off = torch.where(ix <= g, ix, ix - 2 * g).double() * h
    r2 = off[:, None] ** 2 + off[None, :] ** 2
    k0 = 1.0 / (1.0 + r2)
    pad = grid.new_zeros((3, 2 * g, 2 * g))
    pad[:, :g, :g] = grid.view(3, g, g)
    mf = torch.fft.rfft2(pad)
    c1 = torch.fft.irfft2(mf * torch.fft.rfft2(k0 * k0)[None],
                          s=(2 * g, 2 * g))[:, :g, :g]
    c0 = torch.fft.irfft2(mf[0] * torch.fft.rfft2(k0), s=(2 * g, 2 * g))[
        :g, :g]
    fields = torch.cat([c1, c0[None]]).reshape(4, g * g)
    got = torch.zeros((n, 4), dtype=torch.float64, device=y.device)
    for dx, dy, w in corners:
        got += w[:, None] * fields[:, (i0[:, 0] + dx) * g + i0[:, 1] + dy].T
    return got[:, :1] * y - got[:, 1:3], (got[:, 3].sum() - n).clamp(min=1e-12)


def tsne_grad(y: torch.Tensor, p: SparseP, exaggeration: float, g: int,
              dt: torch.dtype) -> torch.Tensor:
    """The sparse tSNE gradient 4·(Σ_j exag·P_ij·q_ij·(y_i − y_j) −
    rep_i / Z), q_ij = (1+|y_i−y_j|²)⁻¹, attraction over P's support."""
    y = rnd(y, dt).double()
    diff = y[p.src] - y[p.dst]
    num = 1.0 / (1.0 + (diff * diff).sum(1))
    att = torch.zeros_like(y).index_add_(
        0, p.src, (exaggeration * p.val.double() * num)[:, None] * diff)
    rep, z = pm_repulsion(rnd(y.float(), dt), g)
    return rnd((4.0 * (att - rep / z)).float(), dt)


def tsne_update(y: torch.Tensor, vel: torch.Tensor, gains: torch.Tensor,
                grad: torch.Tensor, mom: float, lr: float, min_gain: float,
                dt: torch.dtype) -> torch.Tensor:
    """One momentum step with per-coordinate gains (×0.8 where the
    gradient keeps the velocity's sign, +0.2 elsewhere, at least
    ``min_gain``), then the map recentred on its mean."""
    gains = torch.where(torch.sign(grad) == torch.sign(vel), gains * 0.8,
                        gains + 0.2).clamp(min=min_gain)
    y = rnd(y + rnd(mom * vel - lr * gains * grad, dt), dt)
    return rnd(y - y.double().mean(0, keepdim=True).float(), dt)
