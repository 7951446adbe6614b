"""Sketch-and-Scale end to end (paper Fig. 1), one-shot, on the card.

    1. set a regular grid            → core.quantize.fit_grid
    2. count points, find heavy bins → one sort + RLE feeding both the
                                        sketch scatter and the candidate
                                        top-k, then core.heavy_hitters
    3. representatives per heavy bin → core.replicas
    4. embed them with tSNE or UMAP  → core.tsne / core.umap

Entry points (:func:`run`, :func:`run_streaming`, :func:`sketch_stage`,
:func:`sketch_stage_streaming`, :func:`embed_stage`) run on the card
unless the caller asks for another device: ``device=None`` means
``cuda`` and raises where there is none.  The hash parameters and the
replica jitter are the reference's own threefry draws (``core.prng``):
the hash parameters from ``key(seed)``, the jitter under the key
``split(key(seed + 1))[0]``, keyed by cell.  The embedder's init and
UMAP's negatives come from a ``torch.Generator`` seeded from
``cfg.seed + 1`` on the run's device.  :class:`Draws` takes any of them
from outside instead.

The approximate kNN build (``core.ann``) draws from its own generators
seeded from ``AnnConfig.seed``; ``Draws.ann`` takes them from outside.

A chunk iterator or factory instead of an (N, D) array takes the
streaming path (:func:`run_streaming`): a min/max pass fits the grid when
none is given, then ``core.stream`` folds the host chunks on the device
in bounded memory.  :func:`run_resilient` takes independent per-shard
chunk sources instead and survives lost, late and corrupt shards
(``core.geo``, ``core.resilience``, ``core.faults``).

The mesh tier (``core.mesh``): with ``mesh=`` (a ``DeviceMesh``) every
rank calls :func:`run` with its own row block of the points, or
:func:`run_streaming` with ``shard_fn=``; the sketch stage runs through
``geo.geo_extract`` / ``geo.geo_extract_from_shards`` and every rank
ends with the same heavy hitters, then embeds them.  ``cfg.embed_mesh``
row-block-shards the embed over the ranks of a 1-D mesh: UMAP
(``umap.run_umap(mesh=)``) or sparse tSNE (``tsne.run_tsne(mesh=)``,
its kNN graph exact or approximate, built sharded too); every rank gets
the whole embedding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import geo, hashing, prng, quantize, replicas
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core import spans
from repro_torch.core import stream as stream_mod
from repro_torch.core import tsne as tsne_mod
from repro_torch.core import u64
from repro_torch.core import umap as umap_mod
from repro_torch.core.ann import AnnDraws
from repro_torch.core.device import resolve_device
from repro_torch.core.heavy_hitters import HeavyHitters
from repro_torch.core.quantize import GridSpec
from repro_torch.core.replicas import Representatives


@dataclasses.dataclass(frozen=True)
class SnsConfig:
    """Paper-parameterized pipeline config (defaults = cancer experiment).
    The reference's fields and validation, less ``kernel_mode``: the
    port's kernels are chosen by the tensors' device."""
    bins: int = 25                 # M, linear bins per axis
    rows: int = 16                 # R, sketch rows
    log2_cols: int = 18            # C = 2^18 ≈ the paper's 2·10^5
    top_k: int = 20_000            # heavy hitters to extract
    candidate_pool: int = 0        # 0 -> 2*top_k
    ingest_chunk: int = 65_536     # streaming ingest (ROADMAP P11)
    ingest_superbatch: int = 8     # streaming ingest (ROADMAP P11)
    replica_scheme: str = "count"  # "uniform" | "rank" | "count"
    max_replicas: int = 8
    jitter_frac: float = 0.25
    embedder: str = "umap"         # "umap" | "tsne"
    embed_dims: int = 2
    embed_backend: str = "dense"   # tSNE gradient backend (core.tsne)
    embed_block: int = 512         # row-block: kNN build, calibration, tiles
    embed_knn: int = 0             # sparse tSNE fan-out (0 = 3·perplexity)
    embed_grid: int = 128          # sparse tSNE grid G
    embed_grid_interval: float = 0.0
    embed_grid_max: int = 1024
    embed_cic: str = "xla"         # validated; selects nothing (core.tsne)
    # kNN build: "exact" | "auto" (exact up to 2¹⁶ points) | "ann"
    # (the approximate engine, core.ann)
    embed_knn_method: str = "auto"
    embed_ann: object = None
    embed_mesh: object = None      # None | rank count | 1-D DeviceMesh
    seed: int = 0

    def __post_init__(self):
        """Fail-loud validation, naming the knob."""
        checks = [
            (self.bins >= 2, f"bins (grid M) must be >= 2, got {self.bins}"),
            (self.rows >= 1,
             f"rows (sketch R) must be >= 1 — a zero-row sketch estimates "
             f"nothing; got {self.rows}"),
            (1 <= self.log2_cols <= 31,
             f"log2_cols must be in [1, 31], got {self.log2_cols}"),
            (self.top_k >= 1, f"top_k must be >= 1, got {self.top_k}"),
            (self.candidate_pool >= 0,
             f"candidate_pool must be >= 0 (0 = 2*top_k), "
             f"got {self.candidate_pool}"),
            (self.ingest_chunk >= 1,
             f"ingest_chunk must be >= 1, got {self.ingest_chunk}"),
            (self.ingest_superbatch >= 1,
             f"ingest_superbatch must be >= 1 (1 = off), "
             f"got {self.ingest_superbatch}"),
            (self.replica_scheme in ("uniform", "rank", "count"),
             f"replica_scheme must be 'uniform'|'rank'|'count', "
             f"got {self.replica_scheme!r}"),
            (self.max_replicas >= 1,
             f"max_replicas must be >= 1, got {self.max_replicas}"),
            (0.0 <= self.jitter_frac <= 1.0,
             f"jitter_frac must be in [0, 1] (fraction of a cell), "
             f"got {self.jitter_frac}"),
            (self.embedder in ("umap", "tsne"),
             f"embedder must be 'umap'|'tsne', got {self.embedder!r}"),
            (self.embed_dims >= 1,
             f"embed_dims must be >= 1, got {self.embed_dims}"),
            (self.embed_backend in ("dense", "tiled", "pallas", "sparse"),
             f"embed_backend must be 'dense'|'tiled'|'pallas'|'sparse', "
             f"got {self.embed_backend!r}"),
            (self.embed_block >= 1,
             f"embed_block must be >= 1, got {self.embed_block}"),
            (self.embed_knn >= 0,
             f"embed_knn must be >= 0 (0 = 3*perplexity), "
             f"got {self.embed_knn}"),
            (self.embed_grid >= 2,
             f"embed_grid must be >= 2, got {self.embed_grid}"),
            (self.embed_grid_interval >= 0.0,
             f"embed_grid_interval must be >= 0 (0 = fixed grid), "
             f"got {self.embed_grid_interval}"),
            (self.embed_grid_max >= self.embed_grid,
             f"embed_grid_max ({self.embed_grid_max}) must be >= "
             f"embed_grid ({self.embed_grid})"),
            (self.embed_cic in ("xla", "pallas"),
             f"embed_cic must be 'xla'|'pallas', got {self.embed_cic!r}"),
            (self.embed_knn_method in ("exact", "auto", "ann"),
             f"embed_knn_method must be 'exact'|'auto'|'ann', "
             f"got {self.embed_knn_method!r}"),
        ]
        bad = [msg for ok, msg in checks if not ok]
        if bad:
            raise ValueError("invalid SnsConfig: " + "; ".join(bad))


class Draws(NamedTuple):
    """Random draws taken from outside instead of the run's generators
    (see carry.py).  Each is optional."""
    hash_params: Optional[hashing.MulShiftParams] = None
    jitter: Optional[torch.Tensor] = None      # (K, max_replicas, D) f32
    umap_init: Optional[torch.Tensor] = None   # (N_reps, dims) f32
    negatives: Optional[torch.Tensor] = None   # (n_epochs, E, neg_rate) i64
    tsne_init: Optional[torch.Tensor] = None   # (N_reps, dims) f32
    ann: Optional[AnnDraws] = None             # the approximate kNN's


@dataclasses.dataclass
class SnsResult:
    grid: GridSpec
    hh: HeavyHitters
    reps: Representatives
    embedding: torch.Tensor        # (live_reps, embed_dims)
    rep_weight: torch.Tensor       # weights of live reps
    rep_hh_id: torch.Tensor        # HH index of each live rep
    coverage: float                # fraction of the points in the HHs
    # largest exact count withheld from the candidate set (local top-L
    # truncation); 0.0 = the candidates hold every occupied cell
    hh_error_bound: float = 0.0
    # the map's spans (core.spans): host seconds by dotted path, the
    # stages ("sketch", "replicas", "embed", ...) each ending in a device
    # synchronize, and on CUDA "<path>@device", the device's seconds
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # tSNE's per-iteration KL on the device (None for UMAP); the
    # reference's embed_points returns it, its run drops it
    kl_trace: Optional[torch.Tensor] = None
    # fraction of the expected stream mass ingest observed: below 1.0
    # only on the resilient path after shard loss (distinct from
    # `coverage`, the heavy hitters' share OF the observed)
    ingest_coverage: float = 1.0
    # shard ids the resilient path lost (empty on every other path)
    lost_shards: Tuple[int, ...] = ()


def _is_points_array(points) -> bool:
    return hasattr(points, "shape")


def _chunk_stream(chunks) -> Iterable:
    """One pass over a chunk source: a callable factory or an iterable."""
    return chunks() if callable(chunks) else iter(chunks)


def _points_tensor(points, device: torch.device) -> torch.Tensor:
    pts = torch.as_tensor(points, device=device)
    return pts.reshape(-1, pts.shape[-1]).to(torch.float32)


def _hash_params(cfg: SnsConfig, dev: torch.device,
                 hash_params: Optional[hashing.MulShiftParams]
                 ) -> hashing.MulShiftParams:
    """The given hash parameters on ``dev``, else the reference's draw
    from ``cfg.seed`` (``geo.shared_params``)."""
    return geo.shared_params(cfg.seed, cfg.rows, dev, hash_params)


def _mesh_grid(cfg: SnsConfig, pts: torch.Tensor, mesh, data_axes
               ) -> GridSpec:
    """The grid of the global array from every rank's shard: each rank's
    per-dimension min and max, all-reduced MIN/MAX over ``data_axes``.
    Min and max are exact, so this equals ``fit_grid`` on the
    concatenation bit for bit; no rank sees another's rows."""
    d = pts.shape[-1]
    if pts.shape[0]:
        lo, hi = pts.amin(0), pts.amax(0)
    else:
        lo = torch.full((d,), float("inf"), device=pts.device)
        hi = torch.full((d,), float("-inf"), device=pts.device)
    lo = mesh_mod.all_reduce(lo, mesh, data_axes, "min")
    hi = mesh_mod.all_reduce(hi, mesh, data_axes, "max")
    return quantize.fit_grid(pts, cfg.bins, lo=lo.cpu().numpy(),
                             hi=hi.cpu().numpy())


def _mesh_extract(cfg: SnsConfig, pts: torch.Tensor,
                  grid: Optional[GridSpec], mesh, data_axes,
                  dev: torch.device,
                  hash_params: Optional[hashing.MulShiftParams]
                  ) -> Tuple[GridSpec, "geo.GeoSketchResult"]:
    """The mesh sketch stage on this rank's shard: the agreed grid (from
    the shards' min/max when none is given), then ``geo.geo_extract``."""
    data_axes = mesh_mod.check_axes(mesh, data_axes)
    if grid is None:
        grid = _mesh_grid(cfg, pts, mesh, data_axes)
    return grid, geo.geo_extract(
        mesh, grid, pts, rows=cfg.rows, log2_cols=cfg.log2_cols,
        top_k=cfg.top_k, candidate_pool=cfg.candidate_pool,
        data_axes=data_axes, seed=cfg.seed, hash_params=hash_params,
        device=dev)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sketch_stage(cfg: SnsConfig, points, grid: Optional[GridSpec] = None,
                 mesh=None, data_axes=("data",), *, device=None,
                 hash_params: Optional[hashing.MulShiftParams] = None
                 ) -> Tuple[GridSpec, HeavyHitters]:
    """Stages 1-2: grid + heavy hitters.  ``points`` may be a resident
    (N, D) array or a chunk iterator / factory (the streaming path, as
    :func:`sketch_stage_streaming`).  With ``mesh`` every rank passes its
    own row block (see :func:`run`)."""
    grid, hh, _ = _sketch_stage_impl(cfg, points, grid=grid, mesh=mesh,
                                     data_axes=data_axes, device=device,
                                     hash_params=hash_params)
    return grid, hh


def _sketch_stage_impl(cfg: SnsConfig, points, grid: Optional[GridSpec],
                       mesh=None, data_axes=("data",), *, device=None,
                       hash_params: Optional[hashing.MulShiftParams] = None
                       ) -> Tuple[GridSpec, HeavyHitters, float]:
    """Stages 1-2 plus the candidate-stage watermark (the largest count
    withheld from the candidate set; 0 = complete)."""
    dev = resolve_device(device)
    if not _is_points_array(points):
        if mesh is not None:
            raise ValueError(
                "chunk-iterator input is single-host only; use "
                "geo.geo_extract_from_shards for the mesh streaming path")
        grid, state = _ingest_stream(cfg, points, grid, dev, hash_params)
        hh = hh_mod.from_candidates(state.sketch, state.cands, cfg.top_k)
        return grid, hh, float(stream_mod.space_saving_bound(state))
    pts = _points_tensor(points, dev)
    if mesh is not None:
        grid, res = _mesh_extract(cfg, pts, grid, mesh, data_axes, dev,
                                  hash_params)
        return grid, res.hh, float(res.evict_max)
    if grid is None:
        with spans.span("grid"):
            grid = quantize.fit_grid(pts, cfg.bins)
    # one sort + RLE feeds the sketch scatter and the candidate top-k
    with spans.span("keys"):
        key_hi, key_lo = quantize.points_to_keys(grid, pts)
    with spans.span("sort"):
        runs = cand_mod.sorted_runs(
            key_hi, key_lo, assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    del key_hi, key_lo
    with spans.span("update"):
        sk = sketch_mod.init(_hash_params(cfg, dev, hash_params),
                             cfg.log2_cols)
        sk = sketch_mod.update_runs(sk, runs)
    pool = cfg.candidate_pool or min(2 * cfg.top_k, pts.shape[0])
    with spans.span("candidates"):
        cands, dropped = cand_mod.topk_from_runs(runs, pool,
                                                 return_dropped=True)
    with spans.span("estimate"):
        hh = hh_mod.from_candidates(sk, cands, cfg.top_k)
    return grid, hh, float(dropped)


def sketch_stage_streaming(cfg: SnsConfig, chunks,
                           grid: Optional[GridSpec] = None, *, device=None,
                           hash_params: Optional[hashing.MulShiftParams] = None
                           ) -> Tuple[GridSpec, HeavyHitters, float]:
    """Stages 1-2 over a chunk stream, in bounded device memory.

    ``chunks``: an iterable of (n_i, D) host arrays, or a zero-argument
    callable returning one.  With ``grid=None`` two passes are made
    (min/max, then the fold), so the source must be re-iterable: a
    callable or a sequence.  Returns (grid, heavy hitters, items
    ingested), the count from the fold's state."""
    grid, state = _ingest_stream(cfg, chunks, grid, resolve_device(device),
                                 hash_params)
    hh = hh_mod.from_candidates(state.sketch, state.cands, cfg.top_k)
    return grid, hh, float(state.count)


def _ingest_stream(cfg: SnsConfig, chunks, grid: Optional[GridSpec],
                   dev: torch.device,
                   hash_params: Optional[hashing.MulShiftParams]
                   ) -> Tuple[GridSpec, stream_mod.IngestState]:
    """The grid (a min/max pass over the host chunks when none is given)
    and the superbatched fold of the stream on ``dev``: the spans "grid"
    and "ingest", each ending in a read back to the host."""
    if grid is None:
        if not callable(chunks) and iter(chunks) is chunks:
            raise ValueError(
                "grid=None needs two passes over the stream, but `chunks` "
                "is a one-shot iterator; pass a callable / sequence, or "
                "fit the grid up front (quantize.fit_grid_streaming)")
        with spans.span("grid"):
            grid = quantize.fit_grid_streaming(_chunk_stream(chunks),
                                               cfg.bins)
    with spans.span("ingest"):
        pool = cfg.candidate_pool or 2 * cfg.top_k
        state = stream_mod.init(_hash_params(cfg, dev, hash_params),
                                cfg.log2_cols, pool)
        state = stream_mod.ingest_all(state, grid, _chunk_stream(chunks),
                                      cfg.ingest_chunk,
                                      superbatch=cfg.ingest_superbatch)
        empty = float(state.count) == 0.0
    if empty:
        # a factory returning the SAME exhausted iterator passes the
        # re-iterable guard above but yields nothing on the ingest pass
        raise ValueError(
            "ingest pass saw no data; if `chunks` is a callable it must "
            "return a FRESH iterator on every call")
    return grid, state


def resolve_embed_cfg(cfg: SnsConfig,
                      tsne_cfg: Optional[tsne_mod.TsneConfig] = None,
                      umap_cfg: Optional[umap_mod.UmapConfig] = None):
    """The embedder's config with SnsConfig's backend, block, grid and kNN
    knobs applied: SnsConfig is authoritative for them, the tsne/umap
    configs carry the algorithms' hyper-parameters."""
    if cfg.embedder == "tsne":
        tc = tsne_cfg or tsne_mod.TsneConfig(dims=cfg.embed_dims)
        return dataclasses.replace(
            tc, backend=cfg.embed_backend, block=cfg.embed_block,
            knn=cfg.embed_knn, grid_size=cfg.embed_grid,
            grid_interval=cfg.embed_grid_interval,
            grid_max=cfg.embed_grid_max, cic=cfg.embed_cic,
            knn_method=cfg.embed_knn_method, ann=cfg.embed_ann)
    uc = umap_cfg or umap_mod.UmapConfig(dims=cfg.embed_dims)
    return dataclasses.replace(uc, block=cfg.embed_block,
                               knn_method=cfg.embed_knn_method,
                               ann=cfg.embed_ann)


def embed_points(cfg: SnsConfig, x: torch.Tensor, weights: torch.Tensor,
                 ecfg=None, *, init: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 negatives: Optional[torch.Tensor] = None,
                 tsne_cfg=None, umap_cfg=None,
                 ann_draws: Optional[AnnDraws] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the configured embedder on built representatives.  Returns
    (embedding, kl_trace): tSNE's per-iteration KL on the device, or
    None for UMAP.  ``negatives`` is UMAP's only; ``ann_draws`` goes to
    an approximate kNN build.  ``cfg.embed_mesh`` row-block-shards UMAP
    or sparse tSNE over the ranks of its mesh (every rank calls this with
    the same representatives and gets the whole embedding)."""
    embed_mesh = mesh_mod.resolve_mesh(cfg.embed_mesh)
    if ecfg is None:
        ecfg = resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)
    if cfg.embedder == "tsne":
        return tsne_mod.run_tsne(x, ecfg, weights=weights, mesh=embed_mesh,
                                 init=init, generator=generator,
                                 ann_draws=ann_draws)
    emb = umap_mod.run_umap(x, ecfg, weights=weights, mesh=embed_mesh,
                            init=init, generator=generator,
                            negatives=negatives, ann_draws=ann_draws)
    return emb, None


def embed_stage(cfg: SnsConfig, grid: GridSpec, hh: HeavyHitters,
                tsne_cfg=None, umap_cfg=None, *, device=None,
                draws: Optional[Draws] = None
                ) -> Tuple[Representatives, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Stages 3-4: replicas + tSNE/UMAP on the live representatives."""
    reps, emb, w, ids, _ = _embed_stage_impl(
        cfg, grid, hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg, device=device,
        draws=draws)
    return reps, emb, w, ids


def _embed_stage_impl(cfg: SnsConfig, grid: GridSpec, hh: HeavyHitters,
                      tsne_cfg=None, umap_cfg=None, *, device=None,
                      draws: Optional[Draws] = None):
    """Stages 3-4 plus tSNE's KL trace (None for UMAP): the spans
    "replicas" and "embed", each ending in a device synchronize."""
    dev = resolve_device(device)
    ecfg = resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)
    draws = draws or Draws()
    with spans.span("replicas", sync=dev):
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed + 1)
        hh = HeavyHitters(*[t.to(dev) for t in hh])
        krep = prng.split(prng.key(cfg.seed + 1, device=dev))[0]
        reps = replicas.make_representatives(
            grid, hh, scheme=cfg.replica_scheme,
            max_replicas=cfg.max_replicas, jitter_frac=cfg.jitter_frac,
            key=krep, jitter=draws.jitter)
        pts, w, ids = replicas.compact(reps)
    init = draws.tsne_init if cfg.embedder == "tsne" else draws.umap_init
    with spans.span("embed", sync=dev):
        emb, kl = embed_points(cfg, pts, w, ecfg, init=init, generator=gen,
                               negatives=draws.negatives,
                               ann_draws=draws.ann)
    return reps, emb, w, ids, kl


def run(cfg: SnsConfig, points, grid: Optional[GridSpec] = None, mesh=None,
        data_axes=("data",), tsne_cfg=None, umap_cfg=None, *, device=None,
        draws: Optional[Draws] = None) -> SnsResult:
    """Full SnS: points → embedding of weighted heavy-hitter
    representatives, on ``device`` (None = the card).  A chunk iterator
    or factory instead of an array goes to :func:`run_streaming`.

    With ``mesh`` (a ``DeviceMesh``) every rank calls this with its own
    row block of the global array (the block ``linear_index(mesh,
    data_axes)``), sharded over ``data_axes``, innermost first.  The
    grid, when none is given, comes from the shards' all-reduced min/max;
    the sketch stage is ``geo.geo_extract``; every rank then holds the
    same heavy hitters and embeds them (``cfg.embed_mesh`` shards that
    too).  ``coverage`` is over the all-reduced point count."""
    if not _is_points_array(points):
        if mesh is not None:
            raise ValueError(
                "chunk-iterator input is single-host only; use "
                "run_streaming(mesh=..., shard_fn=...) for the mesh path")
        return run_streaming(cfg, points, grid=grid, tsne_cfg=tsne_cfg,
                             umap_cfg=umap_cfg, device=device, draws=draws)
    dev = resolve_device(device)
    resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)  # fail early
    draws = draws or Draws()
    with spans.scope(dev) as sc:
        with spans.span("sketch", sync=dev):
            pts = _points_tensor(points, dev)
            if mesh is None:
                grid, hh, bound = _sketch_stage_impl(
                    cfg, pts, grid, device=dev,
                    hash_params=draws.hash_params)
                total = float(pts.shape[0])
            else:
                grid, res = _mesh_extract(cfg, pts, grid, mesh, data_axes,
                                          dev, draws.hash_params)
                hh, bound, total = res.hh, float(res.evict_max), \
                    float(res.total_count)
        reps, emb, w, ids, kl = _embed_stage_impl(
            cfg, grid, hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg, device=dev,
            draws=draws)
    coverage = float(hh.count.sum() / max(total, 1.0))   # a float32 ratio
    return SnsResult(grid=grid, hh=hh, reps=reps, embedding=emb,
                     rep_weight=w, rep_hh_id=ids, coverage=coverage,
                     hh_error_bound=bound, stage_seconds=sc.seconds(),
                     kl_trace=kl)


def run_streaming(cfg: SnsConfig, chunks=None,
                  grid: Optional[GridSpec] = None, mesh=None,
                  data_axes=("data",), shard_fn=None, num_batches: int = 1,
                  tsne_cfg=None, umap_cfg=None, *, device=None,
                  draws: Optional[Draws] = None) -> SnsResult:
    """Full SnS over a stream: no stage holds all N points.

    Single host: ``chunks`` is an iterable of (n_i, D) host arrays or a
    callable factory (re-iterable; needed when ``grid`` is None for the
    min/max pass).  Mesh: every rank passes ``mesh``, ``shard_fn(
    rank_index, batch) -> (points, mask)`` and ``num_batches`` (see
    ``geo.geo_extract_from_shards``); ``grid`` is then required, since
    geo-distributed sites agree on the hypercube without a global data
    pass.  ``coverage`` is the heavy hitters' mass over the fold's
    running count (all-reduced on a mesh).  ``stage_seconds`` holds
    "grid" (the min/max pass, when it runs), "ingest", "extract" (heavy
    hitters from the fold; on a mesh, ingest and extract are one stage,
    "ingest"), "replicas" and "embed"."""
    dev = resolve_device(device)
    resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)  # fail early
    draws = draws or Draws()
    if mesh is not None:
        if shard_fn is None:
            raise ValueError("mesh streaming needs shard_fn + num_batches")
        if grid is None:
            raise ValueError(
                "mesh streaming needs an agreed grid up front (the paper's "
                "shared-hypercube contract); supply grid=")
    elif chunks is None:
        raise ValueError("single-host streaming needs a chunk source")
    with spans.scope(dev) as sc:
        if mesh is not None:
            with spans.span("ingest", sync=dev):
                res = geo.geo_extract_from_shards(
                    mesh, grid, shard_fn, rows=cfg.rows,
                    log2_cols=cfg.log2_cols, top_k=cfg.top_k,
                    candidate_pool=cfg.candidate_pool, data_axes=data_axes,
                    seed=cfg.seed, num_batches=num_batches,
                    hash_params=draws.hash_params, device=dev)
                hh, total = res.hh, float(res.total_count)
                bound = float(res.evict_max)   # the shards' MAX watermark
        else:
            grid, state = _ingest_stream(cfg, chunks, grid, dev,
                                         draws.hash_params)
            with spans.span("extract", sync=dev):
                hh = hh_mod.from_candidates(state.sketch, state.cands,
                                            cfg.top_k)
                total = float(state.count)
                bound = float(stream_mod.space_saving_bound(state))
                del state
        reps, emb, w, ids, kl = _embed_stage_impl(
            cfg, grid, hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg, device=dev,
            draws=draws)
    coverage = float(hh.count.sum()) / max(total, 1.0)
    return SnsResult(grid=grid, hh=hh, reps=reps, embedding=emb,
                     rep_weight=w, rep_hh_id=ids, coverage=coverage,
                     hh_error_bound=bound, stage_seconds=sc.seconds(),
                     kl_trace=kl)


def run_resilient(cfg: SnsConfig, shard_chunks, grid: GridSpec, *,
                  policy=None, deadline: Optional[float] = None,
                  min_coverage: float = 0.0, expected_counts=None,
                  faults=None, tsne_cfg=None, umap_cfg=None, device=None,
                  draws: Optional[Draws] = None) -> SnsResult:
    """Full SnS over independent per-shard chunk sources, with failure
    handling: the fault-tolerant front end of :func:`run_streaming`, on
    ``device`` (None = the card).

    Each shard folds its own stream into a summary (host-level jobs, all
    with the same hash parameters), so shards can fail without failing
    the run: transient errors RETRY under ``policy``
    (``resilience.RetryPolicy``), stragglers are cut off at ``deadline``
    seconds, permanent losses DEGRADE into partial aggregation (the
    result carries ``ingest_coverage < 1``, the lost shard ids and an
    ``hh_error_bound`` widened by the estimated lost mass), and coverage
    below ``min_coverage`` FAILS LOUD (``resilience.CoverageError``).
    See ``geo.resilient_extract``; ``faults=`` is the reproducible-chaos
    hook (``core.faults``).  ``stage_seconds`` holds "ingest" (the shard
    jobs, the collection and the merge), "extract", "replicas" and
    "embed".

    ``grid`` is required up front (the shared-hypercube contract: sites
    that may be lost cannot take part in a global min/max pass)."""
    dev = resolve_device(device)
    resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)  # fail early
    draws = draws or Draws()
    with spans.scope(dev) as sc:
        with spans.span("ingest", sync=dev):
            res = geo.resilient_extract(
                grid, shard_chunks, rows=cfg.rows, log2_cols=cfg.log2_cols,
                top_k=cfg.top_k, candidate_pool=cfg.candidate_pool,
                seed=cfg.seed, chunk_size=cfg.ingest_chunk,
                superbatch=cfg.ingest_superbatch, policy=policy,
                deadline=deadline, min_coverage=min_coverage,
                expected_counts=expected_counts, faults=faults, device=dev,
                hash_params=draws.hash_params)
        reps, emb, w, ids, kl = _embed_stage_impl(
            cfg, grid, res.hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg,
            device=dev, draws=draws)
    coverage = float(res.hh.count.sum()) / max(res.observed_count, 1.0)
    return SnsResult(grid=grid, hh=res.hh, reps=reps, embedding=emb,
                     rep_weight=w, rep_hh_id=ids, coverage=coverage,
                     hh_error_bound=res.hh_error_bound,
                     stage_seconds=sc.seconds(),
                     kl_trace=kl, ingest_coverage=res.coverage,
                     lost_shards=res.lost)


def chunks_from_loader(plan, host: int,
                       make_batch: Callable[[int, int], np.ndarray],
                       batches_per_shard: int = 1, steal: bool = False,
                       globally_completed=None,
                       on_shard_done: Optional[Callable[[int], None]] = None,
                       faults=None,
                       on_shard_error: Optional[
                           Callable[[int, Exception], bool]] = None
                       ) -> Callable:
    """Adapt a ``data.loader.ShardPlan`` into the re-iterable chunk
    factory :func:`run_streaming` takes.  Each pass builds a fresh
    ``ShardedLoader`` (iteration mutates its ``completed`` set) and yields
    the raw batches in plan order.

    ``steal=True``: after this host drains its primary slice it takes the
    other hosts' leftovers in the plan's steal order, skipping the shards
    ``globally_completed`` (a zero-argument callable read at steal time,
    or a sequence) names.  ``on_shard_done(shard)`` fires once per shard
    after its last batch.  ``on_shard_error(shard, exc) -> bool`` decides
    a failing shard's fate: True skips it (withheld all-or-nothing),
    False/None re-raises.  ``faults`` (a ``core.faults.FaultPlan``) wraps
    ``make_batch`` with reproducible chaos.

    With ``grid=None`` the pipeline iterates the factory twice (min/max,
    then ingest) while a shared board keeps moving: give the grid up front
    so only the ingest pass claims shards."""
    from repro_torch.data.loader import ShardedLoader

    if faults is not None:
        from repro_torch.core import faults as faults_mod
        make_batch = faults_mod.chaos_make_batch(faults, make_batch)

    def factory():
        loader = ShardedLoader(plan, host, make_batch,
                               batches_per_shard=batches_per_shard,
                               on_error=on_shard_error)

        def drain(pairs):
            prev = None
            for shard, batch in pairs:
                if prev is not None and shard != prev \
                        and on_shard_done is not None:
                    on_shard_done(prev)
                prev = shard
                yield batch
            if prev is not None and on_shard_done is not None:
                on_shard_done(prev)

        yield from drain(iter(loader))
        if steal:
            done = globally_completed() if callable(globally_completed) \
                else (globally_completed or ())
            yield from drain(loader.steal(done))
    return factory


def assign_points_to_hh(grid: GridSpec, hh: HeavyHitters, points,
                        chunk: int = 65536, *, device=None) -> torch.Tensor:
    """Label raw points by their heavy-hitter cell: (N,) int64, the HH
    index of each point's cell, −1 where the cell is not a heavy hitter.

    Used to project HH-level cluster labels back onto the raw data, as
    the paper does for its contingency table (§IV-1).  ``points``, an
    (N, D) host array or tensor, goes to ``device`` (None = the card)
    ``chunk`` rows at a time: each chunk is quantized and its keys
    binary-searched against the sorted live HH keys, so memory beyond
    the labels is O(chunk)."""
    dev = resolve_device(device)
    n = points.shape[0]
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    live = hh.mask.to(dev)
    ids = torch.nonzero(live).squeeze(1)
    hi, lo = hh.key_hi.to(dev)[live], hh.key_lo.to(dev)[live]
    order = torch.argsort(u64.sort_key((hi, lo)), stable=True)
    shi, slo, sids = hi[order], lo[order], ids[order]
    if sids.numel() == 0 or n == 0:
        return out
    chunk = max(1, min(int(chunk), n))
    for s in range(0, n, chunk):
        khi, klo = quantize.points_to_keys(
            grid, _points_tensor(points[s:s + chunk], dev))
        pos = cand_mod._searchsorted_pair(shi, slo, khi, klo, "left")
        pos = pos.clamp_(max=sids.numel() - 1)
        hit = (shi[pos] == khi) & (slo[pos] == klo)
        out[s:s + chunk] = torch.where(hit, sids[pos], -1)
    return out
