"""Geo-distributed sketching, the host tier: the paper's topology (§V) as
independent per-site jobs.

Each site folds its own stream into a (sketch ⊕ reservoir) summary and
ships only that summary; the master merges.  Only hashed, signed sums
cross between sites: the sketch is non-invertible, raw coordinates never
leave a shard.  The sites are host-level jobs (:func:`shard_ingest_jobs`)
run by ``resilience.collect_shards``, so the whole failure menu applies
and is handled by :func:`resilient_extract`: transient errors retry
under a ``resilience.RetryPolicy``, stragglers are cut off at a deadline,
lost shards degrade into partial aggregation (the surviving sketches
merge linearly through ``stream.merge_states``, coverage drops below 1,
the heavy-hitter error bound widens by the estimated lost mass), and
``min_coverage`` is the fail-loud floor.

All jobs fold with the SAME hash parameters (the paper's
identical-hash-functions contract; the merge is linear only under it):
drawn once from a generator seeded from ``seed`` on the run's device, or
given as ``hash_params``.  On the card the jobs' folds run in threads on
one device; each ships its state as CPU tensors and takes its digest
from that copy.

The reference's SPMD tier (:func:`sketch_shard`, :func:`geo_extract`,
:func:`geo_extract_from_shards`: one program over a device mesh) is not
ported yet; each raises ``NotImplementedError`` naming ROADMAP P12.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import hashing
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import resilience
from repro_torch.core import stream as stream_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.heavy_hitters import HeavyHitters
from repro_torch.core.quantize import GridSpec
from repro_torch.core.sketch import CountSketch


def _not_ported(name: str):
    raise NotImplementedError(f"geo.{name} (the mesh-sharded SPMD sketch "
                              f"stage) is not ported yet: ROADMAP P12")


def sketch_shard(*args, **kwargs):
    """One mesh device's sketch work: ROADMAP P12."""
    _not_ported("sketch_shard")


def geo_extract(*args, **kwargs):
    """Mesh-sharded one-shot heavy-hitter extraction: ROADMAP P12."""
    _not_ported("geo_extract")


def geo_extract_from_shards(*args, **kwargs):
    """Mesh-sharded streaming heavy-hitter extraction: ROADMAP P12."""
    _not_ported("geo_extract_from_shards")


def shared_params(seed: int, rows: int, device,
                  hash_params: Optional[hashing.MulShiftParams] = None
                  ) -> hashing.MulShiftParams:
    """The hash parameters every site folds with: ``hash_params`` on
    ``device`` if given, else R drawn from a generator on ``device``
    seeded from ``seed``."""
    if hash_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        hash_params = hashing.make_params(gen, rows)
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
