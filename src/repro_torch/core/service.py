"""Online SnS service: the pipeline as a long-lived serving system, on the
card (the reference's ``repro.core.service``).

The paper's premise is data that never stops arriving at the edge nodes.
The sketch is linear and the reservoir resumable, so an
:class:`SnsService` keeps one live :class:`~repro_torch.core.stream.
IngestState` on its device and serves three operations:

* :meth:`SnsService.update` — fold new chunks into the live state (the
  superbatched ``stream.ingest_all``); no history is read again.  Heavy
  hitters are not extracted here: :meth:`SnsService.needs_refresh` watches
  the drift (share of the mass ingested since the last refresh) and the
  space-saving error watermark against the smallest served HH count.

* :meth:`SnsService.refresh` — heavy hitters → representatives → embed.
  Returning representatives are matched to the previous embedding by
  (packed cell key, replica slot) and start at their old coordinates;
  new ones start at the inverse-square-distance weighted mean of their
  kNN among the matched; the optimizer then runs from that init with no
  early exaggeration and ~10× fewer iterations than a cold start.

* :meth:`SnsService.transform` — out-of-sample embedding of raw query
  points with no optimizer: the kNN of each query among the frozen
  representatives (``neighbors.knn_query``), then barycentric placement
  under 1/(d² + eps) weights, ``transform_chunk`` queries at a time, so
  memory is O(chunk · N_reps), never (Q, N_reps).  The distances that
  weigh the k chosen neighbours are taken directly, as |q − x|², not
  from the Gram identity the search ranks by, so an identity query
  weighs its representative at d = 0 exactly.

The grid is fixed at construction (the paper's shared-hypercube
contract): cell keys, the identity the warm match relies on, compare
across refreshes only under one grid.

Failure semantics:

* :meth:`SnsService.update_shards` ingests per-shard sources through the
  resilience collector: transient shard failures RETRY, stragglers are
  cut off at a deadline, permanent losses DEGRADE into partial
  aggregation (the service keeps serving; ``health()`` reports
  ``coverage < 1`` and the widened error bound), and coverage under
  ``min_coverage`` FAILS LOUD without touching the live fold.
* :meth:`SnsService.refresh` is TRANSACTIONAL: the new snapshot is built
  off to the side and swapped in by one assignment; any exception (an
  out-of-memory on the card included) leaves the previous snapshot
  serving and is recorded in ``health()`` before it propagates.
* :meth:`SnsService.save` writes atomically with a checksum and rotates
  the previous generation to a ``.bak``; :meth:`SnsService.load` falls
  back to it if the newest checkpoint is torn or bit-rotted.  The
  checkpoint's keys and dtypes are the reference's: each package loads
  the other's.
* :meth:`transform` / :meth:`save` before the first refresh raise
  :class:`ServiceNotReadyError` (a ``ValueError``).

Random draws: the hash parameters as in ``pipeline`` (``hash_params=``
takes them from outside), the replica jitter the reference's threefry
draw, the embedder's init and UMAP's negatives from a generator seeded
from ``cfg.seed + 1`` on every refresh (``refresh(draws=...)`` takes
them from outside).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import geo
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import neighbors, pipeline, prng, replicas
from repro_torch.core import resilience
from repro_torch.core import stream as stream_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.pipeline import Draws, SnsConfig
from repro_torch.core.quantize import GridSpec


class ServiceNotReadyError(ValueError):
    """transform()/save() called before the first successful refresh()."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving-side knobs (the pipeline's stay on ``SnsConfig``)."""
    # refresh when the mass ingested since the last refresh exceeds this
    # fraction of the stream...
    refresh_drift: float = 0.1
    # ...or when the space-saving eviction watermark reaches this
    # fraction of the smallest HH count served
    error_ratio: float = 0.5
    # warm refresh iteration budget; 0 → cold budget // warm_factor
    warm_iters: int = 0
    warm_factor: int = 10
    # transform(): kNN fan-out, queries a chunk, and the weight floor
    # w = 1/(d² + eps), small enough that an identity query (d = 0)
    # lands on its representative
    transform_k: int = 8
    transform_chunk: int = 4096
    transform_eps: float = 1e-12

    def __post_init__(self):
        bad = []
        if not 0.0 <= self.refresh_drift <= 1.0:
            bad.append(f"refresh_drift={self.refresh_drift} (need [0, 1])")
        if self.error_ratio < 0:
            bad.append(f"error_ratio={self.error_ratio} (need >= 0)")
        if self.warm_iters < 0:
            bad.append(f"warm_iters={self.warm_iters} (need >= 0)")
        if self.warm_factor < 1:
            bad.append(f"warm_factor={self.warm_factor} (need >= 1)")
        if self.transform_k < 1:
            bad.append(f"transform_k={self.transform_k} (need >= 1)")
        if self.transform_chunk < 1:
            bad.append(f"transform_chunk={self.transform_chunk} "
                       "(need >= 1)")
        if not self.transform_eps > 0:
            bad.append(f"transform_eps={self.transform_eps} (need > 0)")
        if bad:
            raise ValueError("invalid ServiceConfig: " + "; ".join(bad))


@dataclasses.dataclass
class EmbedCache:
    """The frozen serving snapshot the last refresh() produced."""
    rep_cell: np.ndarray      # (live,) uint64 packed cell key
    rep_slot: np.ndarray      # (live,) int32 replica slot within the cell
    rep_x: torch.Tensor       # (live, D) representative data coords
    rep_y: torch.Tensor       # (live, dims) embedded coords
    rep_w: torch.Tensor       # (live,) weights
    rep_ids: torch.Tensor     # (live,) HH index of each rep
    min_hh_count: float       # smallest served HH count (error_ratio gate)


@dataclasses.dataclass
class RefreshResult:
    embedding: torch.Tensor   # (live, dims)
    weights: torch.Tensor     # (live,)
    hh_ids: torch.Tensor      # (live,)
    warm: bool                # did this refresh start from a warm init?
    n_matched: int            # reps started at their previous coordinates
    n_new: int                # reps placed by kNN interpolation
    n_iters: int              # optimizer iterations this refresh ran
    kl_trace: Optional[torch.Tensor]  # tSNE per-iteration KL (None: UMAP)


def _place(q: torch.Tensor, x: torch.Tensor, y: torch.Tensor, k: int,
           eps: float) -> torch.Tensor:
    """Barycentric placement of queries ``q`` among corpus rows ``x``
    embedded at ``y``: the k nearest by ``neighbors.knn_query``, weighted
    by 1/(|q − x|² + eps) with the distances of the chosen rows taken
    directly."""
    idx, _ = neighbors.knn_query(q, x, k)
    d2 = ((q[:, None, :] - x[idx]) ** 2).sum(-1)
    w = 1.0 / (d2 + eps)
    w = w / w.sum(1, keepdim=True)
    return torch.einsum("qk,qkd->qd", w, y[idx])


def _packed_cells(hh: hh_mod.HeavyHitters, ids: torch.Tensor) -> np.ndarray:
    """uint64 packed cell key of each live rep (by its HH index)."""
    packed = (hh.key_hi[ids] << 32) | hh.key_lo[ids]
    return packed.cpu().numpy().view(np.uint64)


def _match(prev_cell: np.ndarray, prev_slot: np.ndarray, cell: np.ndarray,
           slot: np.ndarray) -> np.ndarray:
    """Index into the previous reps of each rep's (cell, slot), −1 where
    it is new: cells become their rank among the previous distinct
    cells, (rank, slot) one int64 code, and the codes a sorted search."""
    at = np.full(cell.shape, -1, np.int64)
    if prev_cell.size == 0 or cell.size == 0:
        return at
    uniq = np.unique(prev_cell)
    m = int(max(prev_slot.max(), slot.max())) + 1

    def code(c, s):
        r = np.searchsorted(uniq, c)
        hit = uniq[np.minimum(r, uniq.size - 1)] == c
        return np.where(hit, r.astype(np.int64) * m + s, -1)
    prev = code(prev_cell, prev_slot)
    order = np.argsort(prev, kind="stable")
    sprev = prev[order]
    new = code(cell, slot)
    pos = np.minimum(np.searchsorted(sprev, new), sprev.size - 1)
    hit = (new >= 0) & (sprev[pos] == new)
    at[hit] = order[pos[hit]]
    return at


class SnsService:
    """Long-lived SnS pipeline on ``device`` (None = the card):
    incremental ingest, warm re-embed, batched out-of-sample transform.
    See the module docstring."""

    def __init__(self, cfg: SnsConfig, grid: GridSpec, *,
                 tsne_cfg=None, umap_cfg=None,
                 service_cfg: Optional[ServiceConfig] = None, device=None,
                 hash_params=None):
        self.cfg = cfg
        self.grid = grid
        self.scfg = service_cfg or ServiceConfig()
        self.device = resolve_device(device)
        self._ecfg = pipeline.resolve_embed_cfg(cfg, tsne_cfg=tsne_cfg,
                                                umap_cfg=umap_cfg)
        pool = cfg.candidate_pool or 2 * cfg.top_k
        self.state = stream_mod.init(
            pipeline._hash_params(cfg, self.device, hash_params),
            cfg.log2_cols, pool)
        self._cache: Optional[EmbedCache] = None
        self._pending = 0.0   # mass ingested since the last refresh
        self._lost_mass = 0.0          # estimated mass of dropped shards
        self._lost_shards: tuple = ()  # shard ids lost across updates
        self._update_retries = 0       # retry attempts spent in updates
        # per-shard attempt counts and latency buckets over the
        # update_shards() calls (operational telemetry, not checkpointed)
        self._shard_latency: Dict[int, Dict[str, object]] = {}
        self._refreshes = 0
        self._refresh_failures = 0
        self._last_refresh: Optional[Dict[str, object]] = None

    # ------------------------------------------------------------ ingest
    def update(self, chunks) -> Dict[str, float]:
        """Fold new data into the live state (no history read again).

        ``chunks``: one (n, D) array, an iterable of them, or a
        zero-argument factory.  Returns points folded, wall seconds
        (ending in a device synchronize), points a second, and the drift
        (``pending_fraction``, ``needs_refresh``)."""
        if pipeline._is_points_array(chunks):
            chunks = [chunks]
        before = float(self.state.count)
        t0 = time.perf_counter()
        self.state = stream_mod.ingest_all(
            self.state, self.grid, pipeline._chunk_stream(chunks),
            self.cfg.ingest_chunk, superbatch=self.cfg.ingest_superbatch)
        absorbed = float(self.state.count) - before   # waits for the fold
        dt = time.perf_counter() - t0
        self._pending += absorbed
        return {"points": absorbed, "seconds": dt,
                "points_per_sec": absorbed / dt if dt > 0 else 0.0,
                "pending_fraction": self.pending_fraction(),
                "needs_refresh": self.needs_refresh()}

    def update_shards(self, shard_chunks, *,
                      policy: Optional[resilience.RetryPolicy] = None,
                      deadline: Optional[float] = None,
                      min_coverage: float = 0.0,
                      expected_counts=None,
                      faults=None) -> Dict[str, float]:
        """Fold per-shard sources into the live state, resiliently.

        ``shard_chunks``: ``{shard_id: chunks-or-factory}`` (or a
        sequence, enumerated).  Each shard folds on its own with the
        live state's hash parameters (retried per ``policy``, cut off at
        ``deadline`` seconds), the survivors merge, and the merge folds
        into the live state.  Lost shards widen the served error bound
        (``health()``); coverage below ``min_coverage`` raises
        ``resilience.CoverageError`` WITHOUT touching the live fold."""
        if not isinstance(shard_chunks, dict):
            shard_chunks = dict(enumerate(shard_chunks))
        jobs = geo.shard_ingest_jobs(
            self.grid, shard_chunks, seed=self.cfg.seed,
            rows=self.cfg.rows, log2_cols=self.cfg.log2_cols,
            pool=int(self.state.cands.capacity),
            chunk_size=self.cfg.ingest_chunk,
            superbatch=self.cfg.ingest_superbatch, faults=faults,
            device=self.device, hash_params=self.state.sketch.params)
        t0 = time.perf_counter()
        agg = resilience.collect_shards(
            jobs, policy=policy, deadline=deadline,
            min_coverage=min_coverage, expected_counts=expected_counts,
            verify=True, device=self.device)
        # only now touch the live fold (a CoverageError above leaves it)
        self.state = stream_mod.merge_states(self.state, agg.state)
        absorbed = float(agg.observed_count)
        pipeline._sync(self.device)
        dt = time.perf_counter() - t0
        self._pending += absorbed
        self._lost_mass += float(agg.lost_mass)
        self._lost_shards = tuple(sorted(set(self._lost_shards)
                                         | set(agg.lost)))
        self._update_retries += agg.retries
        self._fold_shard_latency(agg.statuses)
        return {"points": absorbed, "seconds": dt,
                "points_per_sec": absorbed / dt if dt > 0 else 0.0,
                "coverage": agg.coverage, "lost": list(agg.lost),
                "retries": agg.retries,
                "pending_fraction": self.pending_fraction(),
                "needs_refresh": self.needs_refresh()}

    def _fold_shard_latency(self, statuses) -> None:
        """Add one collector pass's per-shard attempts and latency
        buckets (``resilience.LATENCY_BUCKET_LABELS``) to the running
        histograms."""
        nb = len(resilience.LATENCY_BUCKET_LABELS)
        for st in statuses:
            rec = self._shard_latency.setdefault(
                int(st.shard), {"attempts": 0, "failures": 0,
                                "buckets": [0] * nb})
            rec["attempts"] += int(st.attempts)
            rec["failures"] += 0 if st.ok else 1
            hist = resilience.latency_histogram(st.attempt_seconds)
            rec["buckets"] = [a + b for a, b in zip(rec["buckets"], hist)]

    def pending_fraction(self) -> float:
        """Share of all ingested mass not yet in the served embedding
        (1.0 before the first refresh)."""
        total = float(self.state.count)
        return self._pending / total if total > 0 else 0.0

    def needs_refresh(self) -> bool:
        """Drift / error-bound refresh policy (see ServiceConfig)."""
        if self._cache is None:
            return True
        if self.pending_fraction() >= self.scfg.refresh_drift:
            return True
        return (self.error_bound()
                >= self.scfg.error_ratio * self._cache.min_hh_count)

    def error_bound(self) -> float:
        """Served per-cell count error bound: the space-saving eviction
        watermark widened by the mass of the shards lost in
        :meth:`update_shards` (``resilience.widened_bound``)."""
        return resilience.widened_bound(
            float(stream_mod.space_saving_bound(self.state)),
            self._lost_mass)

    def coverage(self) -> float:
        """Share of the offered stream actually folded (1.0 while no
        shard was ever lost)."""
        seen = float(self.state.count)
        offered = seen + self._lost_mass
        return seen / offered if offered > 0 else 1.0

    # ----------------------------------------------------------- refresh
    def refresh(self, mode: str = "auto", *,
                draws: Optional[Draws] = None) -> RefreshResult:
        """Extract heavy hitters again and re-embed, from the previous
        embedding when possible.

        ``mode``: ``"auto"`` (warm iff a previous embedding exists and
        any representative matches), ``"cold"`` (from scratch),
        ``"warm"`` (fail loudly if there is nothing to warm from).
        ``draws`` (``pipeline.Draws``) takes the embedder's draws from
        outside: the cold init (``umap_init``/``tsne_init``) and UMAP's
        ``negatives``."""
        if mode not in ("auto", "cold", "warm"):
            raise ValueError(f"unknown refresh mode: {mode!r}")
        if mode == "warm" and self._cache is None:
            raise ValueError("warm refresh requested but no previous "
                             "embedding exists; run refresh() first")
        t0 = time.perf_counter()
        try:
            cache, result = self._build_snapshot(mode, draws or Draws())
        except Exception as e:
            # transactional: the half-built snapshot is dropped; the
            # previous one still serves
            self._refresh_failures += 1
            self._last_refresh = {
                "ok": False, "mode": mode, "error": repr(e),
                "seconds": time.perf_counter() - t0}
            raise
        self._cache = cache     # the commit: one assignment
        self._pending = 0.0
        self._refreshes += 1
        self._last_refresh = {
            "ok": True, "mode": mode, "warm": result.warm,
            "n_matched": result.n_matched, "n_new": result.n_new,
            "n_iters": result.n_iters,
            "seconds": time.perf_counter() - t0}
        return result

    def _build_snapshot(self, mode: str, draws: Draws):
        """The next serving snapshot, built off to the side: (EmbedCache,
        RefreshResult); never mutates self."""
        cfg, dev = self.cfg, self.device
        hh = hh_mod.from_candidates(self.state.sketch, self.state.cands,
                                    cfg.top_k)
        # pipeline.embed_stage's key: the reps equal the reference's
        krep = prng.split(prng.key(cfg.seed + 1, device=dev))[0]
        reps = replicas.make_representatives(
            self.grid, hh, scheme=cfg.replica_scheme,
            max_replicas=cfg.max_replicas, jitter_frac=cfg.jitter_frac,
            key=krep, jitter=draws.jitter)
        pts, w, ids = replicas.compact(reps)
        cells = _packed_cells(hh, ids)
        slots = (torch.nonzero(reps.mask).squeeze(1) % cfg.max_replicas
                 ).cpu().numpy().astype(np.int32)

        init, n_matched, n_new = None, 0, 0
        if mode != "cold" and self._cache is not None:
            init, n_matched, n_new = self._warm_init(pts, cells, slots)
        warm = init is not None
        ecfg, n_iters = self._refresh_ecfg(warm)
        if not warm:
            init = draws.tsne_init if cfg.embedder == "tsne" \
                else draws.umap_init
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed + 1)
        emb, trace = pipeline.embed_points(
            cfg, pts, w, ecfg, init=init, generator=gen,
            negatives=draws.negatives, ann_draws=draws.ann)
        live_counts = hh.count[hh.mask]
        cache = EmbedCache(
            rep_cell=cells, rep_slot=slots, rep_x=pts, rep_y=emb, rep_w=w,
            rep_ids=ids,
            min_hh_count=float(live_counts.min()) if live_counts.numel()
            else 0.0)
        pipeline._sync(dev)
        result = RefreshResult(embedding=emb, weights=w, hh_ids=ids,
                               warm=warm, n_matched=n_matched,
                               n_new=n_new, n_iters=n_iters,
                               kl_trace=trace)
        return cache, result

    def _warm_init(self, pts: torch.Tensor, cells: np.ndarray,
                   slots: np.ndarray):
        """Start coordinates for the new reps from the cached embedding:
        returning (cell, slot) identities keep their old position, new
        ones take the weighted mean over their kNN among the matched.
        Returns (init | None, n_matched, n_new)."""
        cache = self._cache
        at = torch.from_numpy(_match(cache.rep_cell, cache.rep_slot, cells,
                                     slots)).to(pts.device)
        matched = at >= 0
        n_matched = int(matched.sum())
        if n_matched == 0:
            return None, 0, 0
        y0 = torch.zeros((pts.shape[0], cache.rep_y.shape[1]),
                         dtype=torch.float32, device=pts.device)
        y0[matched] = cache.rep_y[at[matched]]
        fresh = ~matched
        n_new = pts.shape[0] - n_matched
        if n_new:
            k = min(self.scfg.transform_k, n_matched)
            y0[fresh] = _place(pts[fresh], pts[matched], y0[matched], k,
                               self.scfg.transform_eps)
        return y0, n_matched, n_new

    def _refresh_ecfg(self, warm: bool):
        """Embedder config and iteration count for this refresh.  A warm
        run skips early exaggeration (it would tear the arranged init
        apart) and runs ~10× fewer iterations."""
        ecfg = self._ecfg
        if self.cfg.embedder == "tsne":
            cold = ecfg.n_iter
            if not warm:
                return ecfg, cold
            iters = self.scfg.warm_iters or \
                max(1, cold // self.scfg.warm_factor)
            return dataclasses.replace(
                ecfg, n_iter=iters, exaggeration_iters=0,
                momentum_switch=0), iters
        cold = ecfg.n_epochs
        if not warm:
            return ecfg, cold
        iters = self.scfg.warm_iters or \
            max(1, cold // self.scfg.warm_factor)
        return dataclasses.replace(ecfg, n_epochs=iters), iters

    # ------------------------------------------------------------ health
    def health(self) -> Dict[str, object]:
        """One-call serving and ingest health report (the reference's
        keys)."""
        c = self._cache
        return {
            "serving": c is not None,
            "n_reps": int(c.rep_y.shape[0]) if c is not None else 0,
            "points": float(self.state.count),
            "pending_fraction": self.pending_fraction(),
            "needs_refresh": self.needs_refresh(),
            "hh_error_bound": self.error_bound(),
            "coverage": self.coverage(),
            "lost_shards": self._lost_shards,
            "update_retries": self._update_retries,
            "shard_latency": {
                s: {"attempts": rec["attempts"],
                    "failures": rec["failures"],
                    "buckets": dict(zip(resilience.LATENCY_BUCKET_LABELS,
                                        rec["buckets"]))}
                for s, rec in sorted(self._shard_latency.items())},
            "refreshes": self._refreshes,
            "refresh_failures": self._refresh_failures,
            "last_refresh": self._last_refresh,
        }

    # --------------------------------------------------------- transform
    def transform(self, queries) -> torch.Tensor:
        """Embed raw query points against the served embedding, no
        optimizer: (Q, D) → (Q, dims) on the service's device,
        ``transform_chunk`` queries at a time (memory O(chunk · N_reps))."""
        c = self._cache
        if c is None:
            raise ServiceNotReadyError(
                "transform() needs a served embedding; call "
                "refresh() first")
        q = torch.as_tensor(queries)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        n, dims = q.shape[0], c.rep_y.shape[1]
        out = torch.empty((n, dims), dtype=torch.float32,
                          device=self.device)
        chunk = max(1, min(self.scfg.transform_chunk, n))
        k = min(self.scfg.transform_k, int(c.rep_x.shape[0]))
        for s in range(0, n, chunk):
            qc = q[s:s + chunk].to(self.device, torch.float32)
            out[s:s + chunk] = _place(qc, c.rep_x, c.rep_y, k,
                                      self.scfg.transform_eps)
        return out[0] if squeeze else out

    # ------------------------------------------------------- persistence
    def save(self, path) -> None:
        """Checkpoint the live fold AND the serving snapshot to one
        ``.npz`` (``stream.save_state`` extras, in the reference's keys
        and dtypes).  Atomic and checksummed; the previous generation
        rotates to ``<path>.npz.bak``, which :meth:`load` falls back to."""
        c = self._cache
        if c is None:
            raise ServiceNotReadyError(
                "save() checkpoints the serving snapshot; call refresh() "
                "first (to checkpoint a fold alone, use stream.save_state "
                "on .state)")
        extra = {"pending": np.float64(self._pending),
                 "lost_mass": np.float64(self._lost_mass),
                 "lost_shards": np.asarray(self._lost_shards, np.int64),
                 "update_retries": np.int64(self._update_retries),
                 "rep_cell": c.rep_cell, "rep_slot": c.rep_slot,
                 "rep_x": c.rep_x.cpu().numpy(),
                 "rep_y": c.rep_y.cpu().numpy(),
                 "rep_w": c.rep_w.cpu().numpy(),
                 "rep_ids": c.rep_ids.cpu().numpy().astype(np.int32),
                 "min_hh_count": np.float64(c.min_hh_count)}
        stream_mod.save_state(self.state, path, extra=extra,
                              keep_backup=True)

    @classmethod
    def load(cls, path, cfg: SnsConfig, grid: GridSpec, *,
             tsne_cfg=None, umap_cfg=None,
             service_cfg: Optional[ServiceConfig] = None,
             device=None) -> "SnsService":
        """A service from :meth:`save` (this package's or the
        reference's): the fold continues and the served embedding, if
        one was saved, serves at once.  Checksums are verified; a corrupt
        newest checkpoint falls back to the ``.bak`` generation."""
        svc = cls(cfg, grid, tsne_cfg=tsne_cfg, umap_cfg=umap_cfg,
                  service_cfg=service_cfg, device=device)
        state, extras = stream_mod.load_state(path, with_extra=True,
                                              fallback=True,
                                              device=svc.device)
        svc.state = state
        svc._pending = float(extras.get("pending", 0.0))
        svc._lost_mass = float(extras.get("lost_mass", 0.0))
        svc._lost_shards = tuple(
            int(s) for s in extras.get("lost_shards", ()))
        svc._update_retries = int(extras.get("update_retries", 0))
        if "rep_y" in extras:
            def t(name, dtype):
                return torch.from_numpy(
                    np.asarray(extras[name], dtype)).to(svc.device)
            svc._cache = EmbedCache(
                rep_cell=extras["rep_cell"].astype(np.uint64),
                rep_slot=extras["rep_slot"].astype(np.int32),
                rep_x=t("rep_x", np.float32), rep_y=t("rep_y", np.float32),
                rep_w=t("rep_w", np.float32), rep_ids=t("rep_ids", np.int64),
                min_hh_count=float(extras["min_hh_count"]))
        return svc
