"""Sketch-and-Scale end to end (paper Fig. 1), one-shot, on the card.

    1. set a regular grid            → core.quantize.fit_grid
    2. count points, find heavy bins → one sort + RLE feeding both the
                                        sketch scatter and the candidate
                                        top-k, then core.heavy_hitters
    3. representatives per heavy bin → core.replicas
    4. embed them with tSNE or UMAP  → core.tsne / core.umap

Entry points (:func:`run`, :func:`sketch_stage`, :func:`embed_stage`)
run on the card unless the caller asks for another device: ``device=None``
means ``cuda`` and raises where there is none.  Random draws come from
``torch.Generator``s seeded from ``cfg.seed`` on the run's device (hash
parameters from ``seed``; jitter, the embedder's init and UMAP's
negatives from ``seed + 1``); :class:`Draws` takes any of them from
outside instead.

The approximate kNN build (``core.ann``) draws from its own generators
seeded from ``AnnConfig.seed``; ``Draws.ann`` takes them from outside.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: chunk-iterator input (streaming, P11), ``mesh=`` and
``embed_mesh`` (P12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import hashing, quantize, replicas
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core import tsne as tsne_mod
from repro_torch.core import umap as umap_mod
from repro_torch.core.ann import AnnDraws
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
    embed_mesh: object = None      # mesh-parallel embed: ROADMAP P12
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
    # host seconds per stage, each ending in a device synchronize
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # tSNE's per-iteration KL on the device (None for UMAP); the
    # reference's embed_points returns it, its run drops it
    kl_trace: Optional[torch.Tensor] = None


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises, and the run
    never carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def _points_tensor(points, device: torch.device) -> torch.Tensor:
    if not hasattr(points, "shape"):
        raise NotImplementedError(
            "chunk-iterator input (streaming ingest) is not ported yet: "
            "ROADMAP P11; pass an (N, D) array")
    pts = torch.as_tensor(points, device=device)
    return pts.reshape(-1, pts.shape[-1]).to(torch.float32)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh-sharded sketch stage is not ported "
                                  "yet: ROADMAP P12")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sketch_stage(cfg: SnsConfig, points, grid: Optional[GridSpec] = None,
                 mesh=None, *, device=None,
                 hash_params: Optional[hashing.MulShiftParams] = None
                 ) -> Tuple[GridSpec, HeavyHitters]:
    """Stages 1-2: grid + heavy hitters."""
    grid, hh, _ = _sketch_stage_impl(cfg, points, grid=grid, mesh=mesh,
                                     device=device, hash_params=hash_params)
    return grid, hh


def _sketch_stage_impl(cfg: SnsConfig, points, grid: Optional[GridSpec],
                       mesh=None, *, device=None,
                       hash_params: Optional[hashing.MulShiftParams] = None
                       ) -> Tuple[GridSpec, HeavyHitters, float]:
    """Stages 1-2 plus the candidate-stage watermark (the largest count
    withheld from the candidate set; 0 = complete)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    pts = _points_tensor(points, dev)
    if grid is None:
        grid = quantize.fit_grid(pts, cfg.bins)
    if hash_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        hash_params = hashing.make_params(gen, cfg.rows)
    # one sort + RLE feeds the sketch scatter and the candidate top-k
    key_hi, key_lo = quantize.points_to_keys(grid, pts)
    sk = sketch_mod.init(hash_params.to(dev), cfg.log2_cols)
    runs = cand_mod.sorted_runs(
        key_hi, key_lo, assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    del key_hi, key_lo
    sk = sketch_mod.update_runs(sk, runs)
    pool = cfg.candidate_pool or min(2 * cfg.top_k, pts.shape[0])
    cands, dropped = cand_mod.topk_from_runs(runs, pool, return_dropped=True)
    hh = hh_mod.from_candidates(sk, cands, cfg.top_k)
    return grid, hh, float(dropped)


def resolve_embed_cfg(cfg: SnsConfig,
                      tsne_cfg: Optional[tsne_mod.TsneConfig] = None,
                      umap_cfg: Optional[umap_mod.UmapConfig] = None):
    """The embedder's config with SnsConfig's backend, block, grid and kNN
    knobs applied: SnsConfig is authoritative for them, the tsne/umap
    configs carry the algorithms' hyper-parameters."""
    if cfg.embed_mesh is not None:
        raise NotImplementedError("embed_mesh (mesh-parallel embed) is not "
                                  "ported yet: ROADMAP P12")
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
    an approximate kNN build."""
    if ecfg is None:
        ecfg = resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)
    if cfg.embedder == "tsne":
        return tsne_mod.run_tsne(x, ecfg, weights=weights, init=init,
                                 generator=generator, ann_draws=ann_draws)
    emb = umap_mod.run_umap(x, ecfg, weights=weights, init=init,
                            generator=generator, negatives=negatives,
                            ann_draws=ann_draws)
    return emb, None


def embed_stage(cfg: SnsConfig, grid: GridSpec, hh: HeavyHitters,
                tsne_cfg=None, umap_cfg=None, *, device=None,
                draws: Optional[Draws] = None,
                stage_seconds: Optional[Dict[str, float]] = None
                ) -> Tuple[Representatives, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Stages 3-4: replicas + tSNE/UMAP on the live representatives."""
    reps, emb, w, ids, _ = _embed_stage_impl(
        cfg, grid, hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg, device=device,
        draws=draws, stage_seconds=stage_seconds)
    return reps, emb, w, ids


def _embed_stage_impl(cfg: SnsConfig, grid: GridSpec, hh: HeavyHitters,
                      tsne_cfg=None, umap_cfg=None, *, device=None,
                      draws: Optional[Draws] = None,
                      stage_seconds: Optional[Dict[str, float]] = None):
    """Stages 3-4 plus tSNE's KL trace (None for UMAP)."""
    dev = resolve_device(device)
    ecfg = resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)
    draws = draws or Draws()
    times = {} if stage_seconds is None else stage_seconds
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed + 1)
    hh = HeavyHitters(*[t.to(dev) for t in hh])
    reps = replicas.make_representatives(
        grid, hh, scheme=cfg.replica_scheme, max_replicas=cfg.max_replicas,
        jitter_frac=cfg.jitter_frac, generator=gen, jitter=draws.jitter)
    pts, w, ids = replicas.compact(reps)
    _sync(dev)
    t1 = time.perf_counter()
    init = draws.tsne_init if cfg.embedder == "tsne" else draws.umap_init
    emb, kl = embed_points(cfg, pts, w, ecfg, init=init, generator=gen,
                           negatives=draws.negatives, ann_draws=draws.ann)
    _sync(dev)
    times["replicas"] = t1 - t0
    times["embed"] = time.perf_counter() - t1
    return reps, emb, w, ids, kl


def run(cfg: SnsConfig, points, grid: Optional[GridSpec] = None, mesh=None,
        tsne_cfg=None, umap_cfg=None, *, device=None,
        draws: Optional[Draws] = None) -> SnsResult:
    """Full SnS: points → embedding of weighted heavy-hitter
    representatives, on ``device`` (None = the card)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg)  # fail early
    draws = draws or Draws()
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    pts = _points_tensor(points, dev)
    grid, hh, bound = _sketch_stage_impl(cfg, pts, grid, device=dev,
                                         hash_params=draws.hash_params)
    _sync(dev)
    times["sketch"] = time.perf_counter() - t0
    reps, emb, w, ids, kl = _embed_stage_impl(
        cfg, grid, hh, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg, device=dev,
        draws=draws, stage_seconds=times)
    coverage = float(hh.count.sum() / max(pts.shape[0], 1))
    return SnsResult(grid=grid, hh=hh, reps=reps, embedding=emb,
                     rep_weight=w, rep_hh_id=ids, coverage=coverage,
                     hh_error_bound=bound, stage_seconds=times,
                     kl_trace=kl)

