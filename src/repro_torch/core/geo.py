"""Geo-distributed sketching: the paper's topology (§V) in two tiers.

Data at different sites is sketched in place; only the fixed-size
sketches move, and they merge by addition.  Only hashed, signed sums
cross between sites: the sketch is non-invertible, raw coordinates never
leave a shard.

The SPMD tier (:func:`sketch_shard`, :func:`geo_extract`,
:func:`geo_extract_from_shards`) runs one program on every rank of a
``torch.distributed`` mesh (``core.mesh``): each rank sketches its own
row block, the tables all-reduce over ``("data", "pod")`` (within a data
center, then across), the candidates all-gather, and every rank recovers
the same global heavy hitters.  Collectives cannot lose a participant,
so a dead rank fails the whole run: this tier is all-or-nothing.

The host tier: each site folds its own stream into a (sketch ⊕
reservoir) summary and ships only that summary; the master merges.  The
sites are host-level jobs (:func:`shard_ingest_jobs`)
run by ``resilience.collect_shards``, so the whole failure menu applies
and is handled by :func:`resilient_extract`: transient errors retry
under a ``resilience.RetryPolicy``, stragglers are cut off at a deadline,
lost shards degrade into partial aggregation (the surviving sketches
merge linearly through ``stream.merge_states``, coverage drops below 1,
the heavy-hitter error bound widens by the estimated lost mass), and
``min_coverage`` is the fail-loud floor.

All jobs fold with the SAME hash parameters (the paper's
identical-hash-functions contract; the merge is linear only under it):
the reference's threefry draw from ``seed`` (:func:`shared_params`, the
same bits on every device and rank), or given as ``hash_params``.  On
the card the host tier's jobs fold in threads on one device; each ships
its state as CPU tensors and takes its digest from that copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.core import candidates as cand_mod
from repro_torch.core import faults as faults_mod
from repro_torch.core import hashing
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import prng, quantize, resilience
from repro_torch.core import sketch as sketch_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core.candidates import Candidates
from repro_torch.core.device import resolve_device
from repro_torch.core.heavy_hitters import HeavyHitters
from repro_torch.core.quantize import GridSpec
from repro_torch.core.sketch import CountSketch


class GeoSketchResult(NamedTuple):
    hh: HeavyHitters            # the global top-K, the same on every rank
    merged: CountSketch         # the merged sketch, the same on every rank
    total_count: torch.Tensor   # all-reduced item count (stream mass)
    # all-reduced MAX of the candidate stage's watermark: the largest
    # count any shard withheld from the candidate set (local top-L cut in
    # the one-shot path, reservoir eviction in the streaming path); 0 ⇒
    # every occupied cell was proposed, the HH candidate set is complete
    evict_max: torch.Tensor


def sketch_shard(sk: CountSketch, grid: GridSpec, points: torch.Tensor,
                 candidate_pool: int, mask: Optional[torch.Tensor] = None
                 ) -> Tuple[CountSketch, Candidates, torch.Tensor]:
    """One site's work: quantize → pack → ONE sort + RLE feeding both the
    sketch scatter (K7 on the card) and the local top-L.  Also returns the
    local truncation watermark (the largest count not proposed; 0 =
    none)."""
    key_hi, key_lo = quantize.points_to_keys(grid, points)
    runs = cand_mod.sorted_runs(
        key_hi, key_lo, mask=mask,
        assume_hi_zero=grid.dims * grid.bits_per_dim <= 32)
    del key_hi, key_lo
    sk = sketch_mod.update_runs(sk, runs)
    cands, dropped = cand_mod.topk_from_runs(runs, candidate_pool,
                                             return_dropped=True)
    return sk, cands, dropped


def _reduced(mesh, axes, hh: HeavyHitters, merged: CountSketch,
             count: torch.Tensor, evict: torch.Tensor) -> GeoSketchResult:
    return GeoSketchResult(
        hh=hh, merged=merged,
        total_count=mesh_mod.all_reduce(count, mesh, axes, "sum"),
        evict_max=mesh_mod.all_reduce(evict, mesh, axes, "max"))


def geo_extract(mesh, grid: GridSpec, points, *, rows: int, log2_cols: int,
                top_k: int, candidate_pool: int = 0,
                data_axes: Union[str, Sequence[str]] = ("data",),
                seed: int = 0,
                hash_params: Optional[hashing.MulShiftParams] = None,
                device=None) -> GeoSketchResult:
    """Distributed heavy-hitter extraction; every rank of ``mesh`` calls
    it with its own shard.

    ``points``: this rank's (n, D) rows, on the host or a device; they go
    to ``device`` (None = the card).  The rank whose ``linear_index(mesh,
    data_axes)`` is r holds the r-th contiguous row block of the global
    array; no rank sees another's rows.  Each rank sketches its shard,
    the sketches all-reduce (``data_axes`` innermost first), the
    candidates all-gather, and every rank recovers the same global
    top-K.  All ranks fold with the same hash parameters: the
    reference's draw from ``seed``, or ``hash_params``."""
    data_axes = mesh_mod.check_axes(mesh, data_axes)
    dev = resolve_device(device)
    pool = candidate_pool or 2 * top_k
    pts = torch.as_tensor(points, device=dev)
    pts = pts.reshape(-1, pts.shape[-1]).to(torch.float32)
    sk0 = sketch_mod.init(shared_params(seed, rows, dev, hash_params),
                          log2_cols)
    sk, cands, dropped = sketch_shard(sk0, grid, pts, pool)
    hh, merged = hh_mod.distributed_extract(sk, cands, top_k, data_axes,
                                            mesh)
    n_local = torch.full((), pts.shape[0], dtype=torch.float32, device=dev)
    return _reduced(mesh, data_axes, hh, merged, n_local,
                    dropped.to(torch.float32))


def geo_extract_from_shards(mesh, grid: GridSpec,
                            shard_fn: Callable[[int, int], tuple], *,
                            rows: int, log2_cols: int, top_k: int,
                            candidate_pool: int = 0,
                            data_axes: Union[str, Sequence[str]] = ("data",),
                            seed: int = 0, num_batches: int = 1,
                            hash_params: Optional[hashing.MulShiftParams]
                            = None, device=None) -> GeoSketchResult:
    """Streaming variant: each rank loads its own batches through
    ``shard_fn(rank_index, batch) -> (points, mask)`` (``rank_index`` is
    ``linear_index(mesh, data_axes)``, ``batch`` in
    ``range(num_batches)``, ``mask`` None or an (n,) bool) and folds them
    one at a time with ``stream.ingest_step`` (one sort a batch, K7 on
    the card), so a rank's memory is O(batch + candidate_pool + sketch)
    whatever the stream's length.  Then the same merge as
    :func:`geo_extract`."""
    data_axes = mesh_mod.check_axes(mesh, data_axes)
    dev = resolve_device(device)
    pool = candidate_pool or 2 * top_k
    idx = mesh_mod.linear_index(mesh, data_axes)
    st = stream_mod.from_sketch(
        sketch_mod.init(shared_params(seed, rows, dev, hash_params),
                        log2_cols), pool)
    for b in range(num_batches):
        pts, mask = shard_fn(idx, b)
        pts = torch.as_tensor(pts, device=dev)
        pts = pts.reshape(-1, pts.shape[-1]).to(torch.float32)
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev).reshape(-1)
        st = stream_mod.ingest_step(st, grid, pts, mask=mask)
    hh, merged = hh_mod.distributed_extract(st.sketch, st.cands, top_k,
                                            data_axes, mesh)
    return _reduced(mesh, data_axes, hh, merged, st.count, st.evict_max)


def shared_params(seed: int, rows: int, device,
                  hash_params: Optional[hashing.MulShiftParams] = None
                  ) -> hashing.MulShiftParams:
    """The hash parameters every site folds with: ``hash_params`` on
    ``device`` if given, else the reference's draw
    ``make_params(key(seed), rows)`` made on ``device`` (threefry in
    int64 words: every device and every rank draws the same bits)."""
    if hash_params is None:
        hash_params = hashing.make_params(prng.key(seed, device=device),
                                          rows)
    return hash_params.to(device)


class ResilientExtractResult(NamedTuple):
    """The heavy hitters of what arrived, and the quantified damage of
    what was lost."""
    hh: HeavyHitters              # top-K over the OBSERVED sub-stream
    merged: CountSketch           # merge of the shards that delivered
    observed_count: float         # mass actually folded
    coverage: float               # observed / expected   (1.0 = no loss)
    hh_error_bound: float         # survivor watermark + estimated lost mass
    lost: Tuple[int, ...]         # shard ids that never delivered
    statuses: list                # per-shard resilience.ShardStatus
    retries: int                  # extra attempts beyond the first, total


def shard_ingest_jobs(grid: GridSpec, shard_chunks: Mapping, *,
                      seed: int, rows: int, log2_cols: int, pool: int,
                      chunk_size: int, superbatch: int = 1,
                      faults=None, device=None,
                      hash_params: Optional[hashing.MulShiftParams] = None
                      ) -> Dict[int, Callable[[], tuple]]:
    """The per-shard fold jobs ``resilience.collect_shards`` runs.

    ``shard_chunks`` maps shard id → a chunk source (an iterable of
    (n, D) host arrays, or a zero-argument callable returning one;
    callables are called again on each attempt, so a retried shard reads
    its data again).  Every job folds on ``device`` (None = the card)
    with the same hash parameters (:func:`shared_params`), so the states
    merge linearly.  Each job returns ``(state, digest)``: the state as
    CPU tensors and its digest taken from that copy, for the collector's
    ``verify=True``.

    ``faults`` (a :class:`repro_torch.core.faults.FaultPlan`) wraps both
    the chunk stream and the job itself."""
    dev = resolve_device(device)
    params = shared_params(seed, rows, dev, hash_params)
    # the plan splits over its two injection points: delivery faults
    # (drop / flaky / delay) fire once an attempt in chaos_shard_job,
    # whose counter ticks on every attempt, while the chunk wrapper inside
    # the job carries only the data faults (duplicate / corrupt)
    chunk_faults = None if faults is None else dataclasses.replace(
        faults, drop=0.0, drop_shards=(), flaky=0.0, delay=0.0)

    jobs: Dict[int, Callable[[], tuple]] = {}
    for shard, source in shard_chunks.items():
        def job(shard=shard, source=source, attempt_box=[0]):
            attempt = attempt_box[0]
            attempt_box[0] += 1
            chunks = source() if callable(source) else source
            if chunk_faults is not None:
                chunks = faults_mod.chaos_chunks(chunk_faults, shard,
                                                 chunks, attempt=attempt)
            with torch.cuda.device(dev) if dev.type == "cuda" \
                    else contextlib.nullcontext():
                st = stream_mod.init(params, log2_cols, pool)
                st = stream_mod.ingest_all(st, grid, chunks, chunk_size,
                                           superbatch=superbatch)
                st = stream_mod.state_to(st, "cpu")   # ship host bytes
            return st, stream_mod.state_digest(st)
        if faults is not None:
            # job-level faults (drop / flaky / delay / state corruption
            # after the digest) stack on the chunk-level ones
            jobs[shard] = faults_mod.chaos_shard_job(faults, shard, job)
        else:
            jobs[shard] = job
    return jobs


def resilient_extract(grid: GridSpec, shard_chunks, *,
                      rows: int, log2_cols: int, top_k: int,
                      candidate_pool: int = 0, seed: int = 0,
                      chunk_size: int = 65_536, superbatch: int = 1,
                      policy=None, deadline: Optional[float] = None,
                      min_coverage: float = 0.0,
                      expected_counts: Optional[Mapping[int, float]] = None,
                      faults=None, device=None,
                      hash_params: Optional[hashing.MulShiftParams] = None
                      ) -> ResilientExtractResult:
    """Host-level fault-tolerant heavy-hitter extraction on ``device``
    (None = the card).

    Every shard folds its own stream and ships only the summary; the
    master merges what arrived (see the module docstring for what
    retries, degrades and fails loud).  ``shard_chunks``: mapping shard
    id → chunk source, or a sequence (ids 0..S-1).  ``grid`` must be
    agreed up front: geo-distributed sites cannot take a global min/max
    pass."""
    if not isinstance(shard_chunks, Mapping):
        shard_chunks = dict(enumerate(shard_chunks))
    if not shard_chunks:
        raise ValueError("resilient_extract needs at least one shard")
    dev = resolve_device(device)
    pool = candidate_pool or 2 * top_k
    jobs = shard_ingest_jobs(
        grid, shard_chunks, seed=seed, rows=rows, log2_cols=log2_cols,
        pool=pool, chunk_size=chunk_size, superbatch=superbatch,
        faults=faults, device=dev, hash_params=hash_params)
    agg = resilience.collect_shards(
        jobs, policy=policy, deadline=deadline, min_coverage=min_coverage,
        expected_counts=expected_counts, verify=True, device=dev)
    hh = hh_mod.from_candidates(agg.state.sketch, agg.state.cands, top_k)
    return ResilientExtractResult(
        hh=hh, merged=agg.state.sketch,
        observed_count=agg.observed_count, coverage=agg.coverage,
        hh_error_bound=agg.hh_error_bound, lost=agg.lost,
        statuses=agg.statuses, retries=agg.retries)
