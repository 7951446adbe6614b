"""Approximate kNN engine: grid-cell bucketing + NN-descent refinement.

The port of ``repro.core.ann``, single device.  It replaces the exact
O(N²·D) kNN build above ``AnnConfig.auto_threshold`` points (and
wherever ``method="ann"`` asks for it).  Two stages:

**Stage 1 — multi-probe grid-cell bucketing.**  For each of ``probes``
random rotations: rotate, quantize the leading ``key_dims`` coordinates
onto a 2^bits grid between their min and max, interleave the bit-planes
into a Morton cell key and sort the points by key.  Consecutive tiles of
B sorted rows are each scored against a window of 3B candidates (the
tile and one tile of halo on each side) by the distance-tile kernel K4
(``kernels/knn_tile.py``), ``_TILE_CHUNK`` tiles a launch, and each row
keeps its k nearest.  The probes merge by per-row id dedupe + k-merge.

**Stage 2 — NN-descent** (Dong et al.).  Each round samples, per row,
``sample`` forward neighbours and ``sample`` reverse edges (one dst-sort
of the edge list, a random window of each row's in-edges), expands them
to ``sample`` slots of their own neighbour lists, scores the candidates
exactly and k-merges them in, ``block`` rows at a time.  A round that
changes ≤ ``delta·N·k`` entries ends the loop: the reference's
``lax.cond`` early exit, read here on the host once a round.

Ties and orders follow the reference bit for bit: every ``lax.top_k`` is
:func:`candidates.smallest_k` (lower index first among ties and +inf),
and every stable argsort is ``torch.sort(stable=True)``.  Cell keys are
uint32 bit-planes carried in int64.

Draws.  The reference draws from ``jax.random``; the port draws its own
and never reproduces threefry.  Rotations (QR of a Gaussian) and the
reverse-window offsets come from CPU ``torch.Generator``s seeded from
``AnnConfig.seed``, so they are the same on the card and on the CPU.
The per-row descent slots are a counter-based hash of (seed, round,
global row id, slot) mod k: they depend on no row blocking, which is
what keeps a sharded build equal to this one.  :class:`AnnDraws` takes
any of them from outside instead (the parity tests feed the
reference's).

**Mesh build** (``mesh=``: a 1-D mesh, ``core.mesh``; every rank passes
the same ``x``).  Stage 1 shards the tile scan: each rank scores a
contiguous slice of ⌈T/S⌉ sorted tiles through K4, padded with junk tiles
(id −1) so that every rank gathers the same shape, and one all-gather a
probe (indices as int32 and distances, in one tensor) makes the probe
whole; the sort and the probe merge stay replicated.  Stage 2 shards the
refinement by row block: each rank refines its own rows, padded to a
whole number of ``block``-row chunks; a round is one all-gather of the
neighbour blocks and one all-reduce of the change count, which every
rank reads before it decides to stop, so all ranks leave after the same
round.  The draws depend on no blocking, so the mesh graph equals the
single-device graph bit for bit, indices and distances.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import coo
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import spans
from repro_torch.core.candidates import smallest_k
from repro_torch.kernels import knn_tile

_KEY_MAX = 0xFFFFFFFF     # padding key: real keys stay below 2³⁰
# sorted tiles per K4 launch in stage 1: at B = 128 a chunk's
# (1024, 128, 384) float32 distance block is 201 MB
_TILE_CHUNK = 1024
_MERGE_ROWS = 1 << 16     # rows per step of the probe merge
_MASK32 = 0xFFFFFFFF
# multipliers of the draw hash, below 2³¹ so that a product with a 32-bit
# value stays inside int64
_MIX1, _MIX2 = 0x7FEB352D, 0x5BD1E995
_GOLDEN = 0x9E3779B1


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """Knobs of the approximate kNN build: the reference's fields, less
    ``interpret`` and ``kernel_mode`` (the device picks K4's kernel or
    its twin).

    probes          random-rotation bucketing passes k-merged in stage 1
    bucket          sorted tile size B (window = 3B; lifted to ≥ k)
    bits            quantization bit-planes per key dim (clamped so the
                    Morton key fits 30 bits)
    key_dims        leading rotated coordinates folded into the cell key
    iters           NN-descent round cap
    sample          per-side NN-descent sample m: m forward + m reverse
                    seeds, each expanded to m of its neighbours
                    (candidates a round = 2m² + m)
    delta           early exit once a round updates ≤ delta·N·k entries
    rev_cols        reverse edges come from each row's nearest
                    ``rev_cols`` neighbour slots only (0 = all k)
    block           row block of the refinement
    tile            "xla" | "pallas": validated so the reference's
                    configs carry over; it selects nothing here
    auto_threshold  knn_graph(method="auto") switches to ann above this N
    seed            seed of the rotations and of the descent draws
    """
    probes: int = 4
    bucket: int = 128
    bits: int = 10
    key_dims: int = 3
    iters: int = 4
    sample: int = 16
    delta: float = 2e-3
    rev_cols: int = 32
    block: int = 4096
    tile: str = "xla"
    auto_threshold: int = 1 << 16
    seed: int = 0


class AnnDraws(NamedTuple):
    """Random draws of one build or query taken from outside instead of
    the port's own (see carry.py).  Each is optional."""
    rotations: Optional[torch.Tensor] = None  # (probes, D, D), after QR
    offsets: Optional[torch.Tensor] = None    # (iters, N) ints in [0, 2³⁰)
    row_draws: Optional[torch.Tensor] = None  # (iters, N, m + 2m²) in [0, k)


def _check_tile(cfg: AnnConfig) -> None:
    if cfg.tile not in ("pallas", "xla"):
        raise ValueError(f"unknown distance tile backend: {cfg.tile!r}")


def _bucket_size(cfg: AnnConfig, k: int) -> int:
    # every row needs ≥ k real in-window candidates; the window always
    # holds ≥ min(n−1, B) real non-self rows, so lift B to k
    return max(cfg.bucket, k)


def _rotations(seed: int, probes: int, d: int) -> torch.Tensor:
    """(probes, d, d) random orthonormal matrices: QR of Gaussians drawn
    on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.linalg.qr(torch.randn((d, d), generator=gen))[0]
                        for _ in range(probes)])


def _mix32(h):
    """A 32-bit integer finalizer (xorshift-multiply), on Python ints or
    int64 tensors holding values below 2³²."""
    h = h ^ (h >> 16)
    h = (h * _MIX1) & _MASK32
    h = h ^ (h >> 15)
    h = (h * _MIX2) & _MASK32
    return h ^ (h >> 16)


def _hash_draws(seed: int, it: int, rows: torch.Tensor, ndraw: int,
                k: int) -> torch.Tensor:
    """(rows, ndraw) slots in [0, k) for NN-descent round ``it``: a hash of
    (seed, round, global row id, slot), independent of the row blocking."""
    base = _mix32(_mix32(seed & _MASK32) ^ (it & _MASK32))
    h = _mix32(rows[:, None] ^ base)
    slot = torch.arange(ndraw, device=rows.device) * _GOLDEN
    return _mix32((h + slot) & _MASK32) % k


def _cell_keys(xr: torch.Tensor, bits: int, key_dims: int) -> torch.Tensor:
    """Morton cell key of the leading rotated coordinates, (N,) int64
    holding the reference's uint32.  Each of m = min(D, key_dims)
    coordinates goes to 2^bits bins between its min and max; the
    interleaved bit-planes put points near their cell neighbours in key
    order.  bits·m is clamped to 30, below the padding key."""
    n, d = xr.shape
    m = max(1, min(d, key_dims))
    bits = max(1, min(bits, 30 // m))
    u = xr[:, :m]
    lo = u.min(0).values
    span = (u.max(0).values - lo).clamp(min=1e-30)
    nbins = float(1 << bits)
    q = torch.floor((u - lo) / span * nbins).clamp_(0, nbins - 1).long()
    key = torch.zeros((n,), dtype=torch.int64, device=xr.device)
    for b in range(bits):
        for j in range(m):
            key |= ((q[:, j] >> b) & 1) << (b * m + j)
    return key


def _probe_layout(x: torch.Tensor, k: int, rot: torch.Tensor,
                  cfg: AnnConfig, cand_ids: Optional[torch.Tensor] = None):
    """One probe's sorted tile layout: rotate → cell keys → key-sort →
    T = ⌈N/B⌉ query tiles of B rows with 3B halo candidate windows.

    Returns (qx (T,B,D) f32, qid (T,B) int32, cx (T,3B,D), cid (T,3B)
    int32, inv (T·B,) int64): the last tile's tail rows carry id −1 and
    ``inv`` maps row i to its sorted position.  (The reference also pads
    T to a multiple of its ``lax.map`` step with junk tiles; streaming
    with a partial last chunk makes them unnecessary.)  ``cand_ids``
    ((N,) ints) gives the id a row exposes as a candidate: rows carrying
    −1 probe but are never returned (query-vs-corpus mode); None keeps
    the self-join."""
    n, d = x.shape
    dev = x.device
    b = _bucket_size(cfg, k)
    t = -(-n // b)
    n_lay = t * b
    x = x.to(torch.float32)

    keys = _cell_keys(x @ rot.to(dev, torch.float32), cfg.bits,
                      cfg.key_dims)
    keys = torch.cat([keys, keys.new_full((n_lay - n,), _KEY_MAX)])
    order = torch.sort(keys, stable=True)[1]                 # (n_lay,)
    ar = torch.arange(n_lay, device=dev)
    ids = torch.where(ar < n, ar, -1).to(torch.int32)
    cids = ids if cand_ids is None else torch.cat([
        cand_ids.to(dev, torch.int32),
        ids.new_full((n_lay - n,), -1)])
    sx = torch.cat([x, x.new_zeros((n_lay - n, d))])[order]
    halo = x.new_zeros((b, d))
    sx = torch.cat([halo, sx, halo])
    pad = ids.new_full((b,), -1)
    sid = torch.cat([pad, ids[order], pad])
    scid = torch.cat([pad, cids[order], pad])
    qx = sx[b:b + n_lay].reshape(t, b, d)
    qid = sid[b:b + n_lay].reshape(t, b)
    cx = torch.cat([sx[:n_lay].reshape(t, b, d), qx,
                    sx[2 * b:].reshape(t, b, d)], dim=1)
    cid = torch.cat([scid[:n_lay].reshape(t, b),
                     scid[b:b + n_lay].reshape(t, b),
                     scid[2 * b:].reshape(t, b)], dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_lay, device=dev)
    return qx, qid, cx, cid, inv


def _tiles_topk(qx, qid, cx, cid, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every tile against its window (K4, ``_TILE_CHUNK`` tiles a
    launch, the last chunk partial) and keep each row's k nearest.
    Returns (idx, d2) (T·B, k) in sorted-row layout, d2 ascending (junk
    rows: idx −1, d2 +inf)."""
    idx, d2 = [], []
    for s in range(0, qx.shape[0], _TILE_CHUNK):
        e = s + _TILE_CHUNK
        block = knn_tile.distance_tiles(qx[s:e], qid[s:e], cx[s:e], cid[s:e])
        val, pos = smallest_k(block, k)                      # (chunk, B, k)
        ids = cid[s:e].long()[:, None, :].expand(block.shape)
        idx.append(torch.gather(ids, 2, pos).reshape(-1, k))
        d2.append(val.reshape(-1, k))
        del block
    return torch.cat(idx), torch.cat(d2)


def _dedupe_topk(idx: torch.Tensor, d2: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k-merge: drop duplicate ids (stable — the first occurrence
    wins, so callers concat [current, new]) and invalid ids (< 0), then
    keep the k nearest.  Returns (idx (R,k), d2 (R,k)), d2 ascending."""
    idx_s, order = torch.sort(idx, dim=1, stable=True)
    d2_s = torch.gather(d2, 1, order)
    dup = torch.zeros_like(idx_s, dtype=torch.bool)
    dup[:, 1:] = idx_s[:, 1:] == idx_s[:, :-1]
    d2_s = d2_s.masked_fill_(dup | (idx_s < 0), float("inf"))
    val, pos = smallest_k(d2_s, k)
    return torch.gather(idx_s, 1, pos), val


def _merge_probes(probes, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-merge the per-probe (idx, d2) results in one dedupe pass (the
    k-merge is associative), ``_MERGE_ROWS`` rows at a time."""
    if len(probes) == 1:
        return probes[0]
    n = probes[0][0].shape[0]
    out = [_dedupe_topk(torch.cat([p[0][s:s + _MERGE_ROWS] for p in probes],
                                  dim=1),
                        torch.cat([p[1][s:s + _MERGE_ROWS] for p in probes],
                                  dim=1), k)
           for s in range(0, n, _MERGE_ROWS)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def _layout_pos(g: torch.Tensor, rows_per: int, rpp: int) -> torch.Tensor:
    """Layout slot of global row ``g`` when ranks own ``rows_per``
    consecutive rows each, padded to ``rpp`` slots; the single-device
    layout (``rows_per == rpp``) is the identity."""
    if rows_per == rpp:
        return g
    return (g // rows_per) * rpp + g % rows_per


def _reverse_sample(idx_full: torch.Tensor, rid_full: torch.Tensor,
                    off: torch.Tensor, m: int, r: int, n: int
                    ) -> torch.Tensor:
    """``m`` sampled reverse edges per row: sources j that list i as a
    neighbour, (n, m), −1 where a row has fewer.  One stable dst-sort of
    the nearest ``r`` slots of every list + ``coo.row_bounds``, then a
    contiguous window per row at offset ``off`` mod (count − m + 1).
    Padded rows hold dst −1 and sort out of every row's range."""
    dst = idx_full[:, :r].reshape(-1)
    e = dst.shape[0]
    dst_s, order = torch.sort(dst, stable=True)
    bounds = coo.row_bounds(dst_s, n).long()
    lo, hi = bounds[:-1], bounds[1:]
    cnt = hi - lo
    off = off.to(lo.device, torch.int64) % (cnt - m + 1).clamp(min=1)
    j = torch.arange(m, device=lo.device)
    pos = torch.minimum(lo[:, None] + off[:, None] + j[None, :],
                        hi[:, None] - 1).clamp_(0, e - 1)
    src = rid_full[order[pos] // r]                          # (n, m)
    return torch.where(j[None, :] < cnt[:, None], src, -1)


def _refine_chunk(x: torch.Tensor, idx_full: torch.Tensor,
                  rev_all: torch.Tensor, idxc: torch.Tensor,
                  d2c: torch.Tensor, ridc: torch.Tensor,
                  draws: torch.Tensor, cfg: AnnConfig, k: int, n: int,
                  rows_per: int = 0, rpp: int = 0):
    """One NN-descent round for a block of rows, given its (rows,
    m + 2m²) slot draws: sample forward + reverse seeds, expand to their
    neighbour lists, score exactly, k-merge.  Returns (idx, d2, changed);
    padded rows (id −1) pass through.  ``idx_full`` is in the layout of
    ``rows_per`` rows a rank padded to ``rpp`` (:func:`_layout_pos`;
    the defaults: global row order)."""
    rows = ridc.shape[0]
    m = cfg.sample
    inf = float("inf")
    rid_safe = ridc.clamp(min=0)
    fwd = torch.gather(idxc, 1, draws[:, :m])                # (rows, m)
    rev = torch.where(ridc[:, None] >= 0, rev_all[rid_safe], -1)
    union = torch.cat([fwd, rev], dim=1)                     # (rows, 2m)
    upos = _layout_pos(union.clamp(0, n - 1), rows_per, rpp)
    # only the m sampled slots of each seed's neighbour list
    ecols = draws[:, m:].reshape(rows, 2 * m, m)
    expand = idx_full.reshape(-1)[upos[:, :, None] * k + ecols]
    expand = torch.where((union >= 0)[:, :, None], expand, -1)
    cand = torch.cat([rev, expand.reshape(rows, 2 * m * m)], dim=1)
    xi = x[rid_safe]
    xc = x[cand.clamp(0, n - 1)]
    d2n = ((xi[:, None, :] - xc) ** 2).sum(2)
    d2n.masked_fill_((cand < 0) | (cand == ridc[:, None]), inf)
    # candidates already in the row sit below τ by construction and would
    # crowd out every selection slot; at the fixpoint every candidate is
    # a member, the merge returns the row unchanged and `changed` hits 0
    row_sorted = torch.sort(idxc, dim=1)[0]
    pos = torch.searchsorted(row_sorted, cand)
    member = torch.gather(row_sorted, 1, pos.clamp_(0, k - 1)) == cand
    d2n.masked_fill_(member, inf)
    # only candidates below the row's kth distance can enter: pre-select
    # the s best, then dedupe-merge (k + s) wide
    tau = d2c[:, k - 1:k]
    cd, cpos = smallest_k(d2n.masked_fill_(d2n >= tau, inf),
                          min(cand.shape[1], max(2 * m, 48)))
    ci = torch.where(torch.isinf(cd), -1, torch.gather(cand, 1, cpos))
    mi, md = _dedupe_topk(torch.cat([idxc, ci], dim=1),
                          torch.cat([d2c, cd], dim=1), k)
    live = ridc[:, None] >= 0
    mi = torch.where(live, mi, idxc)
    md = torch.where(live, md, d2c)
    return mi, md, ((mi != idxc) & live).sum()


def _nn_descent(x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                row_ids: torch.Tensor, k: int, n: int, cfg: AnnConfig,
                bl: int, draws: AnnDraws, stats: Optional[Dict] = None,
                mesh=None, rid_full: Optional[torch.Tensor] = None,
                rows_per: int = 0, rpp: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``cfg.iters`` rounds over ``bl``-row blocks; a round that
    changes ≤ delta·N·k entries is the last.  Every block of a round
    reads the graph as the round found it.  With ``mesh`` the rows are
    this rank's block in the layout ``rows_per``/``rpp``: each round
    all-gathers the neighbour blocks (int32 on the wire) and all-reduces
    the change count, and ``rid_full`` holds every layout row's id."""
    dev = x.device
    thresh = cfg.delta * n * k
    r = min(cfg.rev_cols, k) if cfg.rev_cols else k
    m = cfg.sample
    ndraw = m + 2 * m * m
    # the offsets' own generator, apart from the rotations' (seed)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    changes: List[int] = []
    for it in range(cfg.iters):
        off = (draws.offsets[it] if draws.offsets is not None else
               torch.randint(0, 1 << 30, (n,), generator=gen))
        if mesh is None:
            idx_full, rif = idx, row_ids
        else:
            idx_full = mesh_mod.all_gather(
                idx.to(torch.int32), mesh, mesh_mod.mesh_axis(mesh)).long()
            rif = rid_full
        rev_all = _reverse_sample(idx_full, rif, off, m, r, n)
        given = None if draws.row_draws is None else \
            draws.row_draws[it].to(dev, torch.int64)
        parts, changed = [], torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(0, idx.shape[0], bl):
            ridc = row_ids[s:s + bl]
            rid_safe = ridc.clamp(min=0)
            rd = given[rid_safe] if given is not None else \
                _hash_draws(cfg.seed, it, rid_safe, ndraw, k)
            mi, md, ch = _refine_chunk(x, idx_full, rev_all, idx[s:s + bl],
                                       d2[s:s + bl], ridc, rd, cfg, k, n,
                                       rows_per, rpp)
            parts.append((mi, md))
            changed += ch
        del idx_full, rev_all
        idx = torch.cat([p[0] for p in parts])
        d2 = torch.cat([p[1] for p in parts])
        if mesh is not None:
            changed = mesh_mod.all_reduce(changed, mesh,
                                          mesh_mod.mesh_axis(mesh))
        changes.append(int(changed))
        if changes[-1] <= thresh:
            break
    if stats is not None:
        stats["descent_iters"] = len(changes)
        stats["descent_changed"] = changes
    return idx, d2


def _ann_build(x: torch.Tensor, k: int, cfg: AnnConfig, draws: AnnDraws,
               stats: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device build: multi-probe candidates → NN-descent.
    Returns (idx (N,k) int64, d2 (N,k) ascending squared distances)."""
    n, d = x.shape
    dev = x.device
    x = x.to(torch.float32)
    with spans.span("probes"):
        rots = draws.rotations if draws.rotations is not None else \
            _rotations(cfg.seed, cfg.probes, d)
        probes = []
        for p in range(cfg.probes):
            lay = _probe_layout(x, k, rots[p], cfg)
            ti, td = _tiles_topk(*lay[:4], k)
            inv = lay[4][:n]
            probes.append((ti[inv], td[inv]))
            del lay, ti, td
        idx, d2 = _merge_probes(probes, k)
        del probes
    with spans.span("descent"):
        bl = min(cfg.block, n)
        r_total = -(-n // bl) * bl
        ar = torch.arange(r_total, device=dev)
        rid = torch.where(ar < n, ar, -1)
        idx = torch.cat([idx, idx.new_full((r_total - n, k), -1)])
        d2 = torch.cat([d2, d2.new_full((r_total - n, k), float("inf"))])
        idx, d2 = _nn_descent(x, idx, d2, rid, k, n, cfg, bl, draws, stats)
    return idx[:n], d2[:n]


def _wire(idx: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(R, k) indices and distances as one (R, 2k) float32 tensor for one
    all-gather: the indices as int32, their bits viewed as float32."""
    return torch.cat([idx.to(torch.int32).view(torch.float32), d2], 1)


def _unwire(w: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_wire`'s inverse: (int64 indices, distances)."""
    return w[:, :k].contiguous().view(torch.int32).long(), \
        w[:, k:].contiguous()


def _tile_slice(a: torch.Tensor, lo: int, count: int, fill
                ) -> torch.Tensor:
    """Tiles [lo, lo + count) of ``a``, padded with junk tiles of
    ``fill`` past its end."""
    part = a[lo:lo + count]
    short = count - part.shape[0]
    if short:
        part = torch.cat([part, a.new_full((short,) + a.shape[1:], fill)])
    return part


def _ann_build_mesh(x: torch.Tensor, k: int, cfg: AnnConfig,
                    draws: AnnDraws, mesh, stats: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh build (see the module docstring): stage 1 shards the tile
    scan, stage 2 the refinement by row block.  Returns the whole
    (idx (N,k) int64, d2 (N,k)) on every rank, equal to
    :func:`_ann_build`'s bit for bit."""
    axis = mesh_mod.mesh_axis(mesh)
    ns = mesh_mod.axis_size(mesh, axis)
    s = mesh.get_local_rank(axis)
    n, d = x.shape
    dev = x.device
    x = x.to(torch.float32)
    with spans.span("probes"):
        rots = draws.rotations if draws.rotations is not None else \
            _rotations(cfg.seed, cfg.probes, d)
        probes = []
        for p in range(cfg.probes):
            lay = _probe_layout(x, k, rots[p], cfg)
            tp = -(-lay[0].shape[0] // ns)                   # tiles a rank
            part = [_tile_slice(a, s * tp, tp, fill)
                    for a, fill in zip(lay[:4], (0.0, -1, 0.0, -1))]
            ti, td = _tiles_topk(*part, k)
            del part
            whole = mesh_mod.all_gather(_wire(ti, td), mesh, axis)
            probes.append(_unwire(whole[lay[4][:n]], k))
            del lay, ti, td, whole
        idx, d2 = _merge_probes(probes, k)
        del probes
    with spans.span("descent"):
        rows_per, _ = mesh_mod.row_block(n, ns)
        bl = min(cfg.block, rows_per)
        rpp = -(-rows_per // bl) * bl
        slot = torch.arange(ns * rpp, device=dev)
        gid = (slot // rpp) * rows_per + slot % rpp
        rid_full = torch.where((slot % rpp < rows_per) & (gid < n), gid, -1)
        rid = rid_full[s * rpp:(s + 1) * rpp]
        live = rid[:, None] >= 0
        safe = rid.clamp(min=0)
        idx_l = torch.where(live, idx[safe], -1)
        d2_l = torch.where(live, d2[safe], float("inf"))
        del idx, d2
        idx_l, d2_l = _nn_descent(x, idx_l, d2_l, rid, k, n, cfg, bl, draws,
                                  stats, mesh=mesh, rid_full=rid_full,
                                  rows_per=rows_per, rpp=rpp)
        whole = mesh_mod.all_gather(_wire(idx_l, d2_l), mesh, axis)
        idx, d2 = _unwire(whole[_layout_pos(torch.arange(n, device=dev),
                                            rows_per, rpp)], k)
    return idx, d2


def ann_knn_graph(x: torch.Tensor, k: int, cfg: Optional[AnnConfig] = None,
                  *, mesh=None, draws: Optional[AnnDraws] = None,
                  stats: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN graph excluding self: (indices (N,k) int64,
    euclidean dists (N,k) ascending), the drop-in for the exact
    ``neighbors.knn_graph``.  Recall ≥ 0.9 against exact on blob data at
    the default config.  ``draws`` replaces the port's own draws.  The
    two stages are the spans "probes" and "descent" (``core.spans``).
    ``stats`` (a dict) receives their seconds (``stage1_s``,
    ``descent_s``: the device's on CUDA, else the host's) and the rounds
    run (``descent_iters``, ``descent_changed``); with it the build opens
    a span scope of its own and synchronizes once at its end.  ``mesh``
    (``None`` | rank count | 1-D ``DeviceMesh``) shards the build over
    its ranks (every rank passes the same ``x`` and gets the whole graph,
    equal to the single-device graph bit for bit)."""
    cfg = cfg if cfg is not None else AnnConfig()
    _check_tile(cfg)
    n = x.shape[0]
    k = min(int(k), max(n - 1, 1))
    mesh = mesh_mod.resolve_mesh(mesh)
    with spans.scope(x.device) if stats is not None \
            else contextlib.nullcontext() as sc:
        if mesh is not None:
            idx, d2 = _ann_build_mesh(x, k, cfg, draws or AnnDraws(), mesh,
                                      stats)
        else:
            idx, d2 = _ann_build(x, k, cfg, draws or AnnDraws(), stats)
    if sc is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        sec = sc.seconds()
        for key, path in (("stage1_s", "probes"), ("descent_s", "descent")):
            stats[key] = sec.get(path + "@device", sec[path])
    return idx, d2.clamp_(min=0.0).sqrt_()


# ----------------------------------------------------- query-vs-corpus mode
# k nearest corpus rows for each query row, corpus frozen (the service's
# transform).  Stage 1 sorts the union [corpus; queries] per probe; query
# rows expose candidate id −1 (they probe but are never returned) and
# carry query ids n + j, so the self mask never fires and an identical
# query keeps its corpus twin at distance 0.  An optional expansion walks
# the corpus's own kNN graph from the probe candidates.

def _ann_query(q: torch.Tensor, x: torch.Tensor,
               corpus_idx: Optional[torch.Tensor], k: int, cfg: AnnConfig,
               expand_k: int, rots: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    m = q.shape[0]
    dev = x.device
    q = q.to(dev, torch.float32)
    allx = torch.cat([x.to(torch.float32), q])
    cand_ids = torch.cat([torch.arange(n, device=dev),
                          torch.full((m,), -1, device=dev)])
    probes = []
    for p in range(cfg.probes):
        lay = _probe_layout(allx, k, rots[p], cfg, cand_ids=cand_ids)
        ti, td = _tiles_topk(*lay[:4], k)
        qpos = lay[4][n:n + m]               # sorted positions of the queries
        probes.append((ti[qpos], td[qpos]))
    idx, d2 = _merge_probes(probes, k)
    if corpus_idx is not None and expand_k > 0:
        # the candidates' own lists, scored exactly: peak O(m·k·e·D)
        ecols = min(expand_k, corpus_idx.shape[1])
        lists = corpus_idx.to(dev, torch.int64)[idx.clamp(0, n - 1), :ecols]
        cand = torch.where((idx >= 0)[:, :, None], lists, -1)
        cand = cand.reshape(m, k * ecols)
        xc = allx[cand.clamp(0, n - 1)]
        d2n = ((q[:, None, :] - xc) ** 2).sum(2)
        d2n.masked_fill_(cand < 0, float("inf"))
        idx, d2 = _dedupe_topk(torch.cat([idx, cand], dim=1),
                               torch.cat([d2, d2n], dim=1), k)
    return idx, d2


def ann_knn_query(q: torch.Tensor, x: torch.Tensor, k: int,
                  cfg: Optional[AnnConfig] = None, *,
                  corpus_graph: Optional[torch.Tensor] = None,
                  expand_k: int = 16, draws: Optional[AnnDraws] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN of ``q`` (Q, D) against the frozen corpus ``x``
    (N, D): (indices (Q, k) int64 into x, euclidean dists (Q, k)
    ascending).  No self-exclusion: a query identical to a corpus row
    returns that row at distance 0.  ``corpus_graph`` ((N, kc) neighbour
    lists, e.g. from :func:`ann_knn_graph`) adds one expansion round of
    ``expand_k`` neighbours per candidate.  Only ``draws.rotations`` is
    read."""
    cfg = cfg if cfg is not None else AnnConfig()
    _check_tile(cfg)
    n, d = x.shape
    k = min(int(k), max(n, 1))
    rots = draws.rotations if draws is not None and \
        draws.rotations is not None else _rotations(cfg.seed, cfg.probes, d)
    idx, d2 = _ann_query(q, x, corpus_graph, k, cfg,
                         0 if corpus_graph is None else int(expand_k), rots)
    return idx, d2.clamp_(min=0.0).sqrt_()
