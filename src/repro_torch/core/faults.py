"""Deterministic fault injection for the distributed ingest / serve path.

The paper's deployment (edge nodes sketch locally, a master merges the
fixed-size summaries) must survive the failures such deployments see:
shards that never report, shards that report late, chunks delivered
twice, bits flipped in transit, checkpoints torn by a crash.  This module
manufactures those failures reproducibly so that the resilience layer
(:mod:`repro_torch.core.resilience`) can be tested instead of trusted.
It is host code (numpy and threads) and a copy of the reference's
``repro.core.faults``: the same plan and seed give the same decisions.

Every decision is a pure function of ``(plan.seed, scope ids)`` through
``np.random.SeedSequence``: no global RNG, no wall clock.  The knobs:

* ``drop``/``drop_shards`` — a shard is permanently dead: every attempt
  fails (retries cannot save it; only partial aggregation can).
* ``flaky``              — an attempt fails transiently: the decision is
  keyed by (shard, attempt), so a bounded retry eventually gets through.
* ``delay``/``delay_seconds`` — a shard is a straggler: it sleeps before
  delivering, which exercises the collector's deadline cutoff.
* ``duplicate``          — a chunk is delivered twice (at-least-once
  transport); the CountSketch is linear, so duplicates bias counts up.
* ``corrupt``            — one bit of a chunk (or of a returned sketch
  state) is flipped; state corruption is caught by the digest check of
  ``resilience.collect_shards(verify=True)``.

Wrappers: :func:`chaos_chunks` (a shard's chunk iterator),
:func:`chaos_make_batch` (a loader's ``make_batch``),
:func:`chaos_shard_job` (a whole shard job as the collector runs it),
:func:`corrupt_file` (checkpoint chaos: flip or truncate).
"""
from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np


class ShardFailure(RuntimeError):
    """An injected (or real) shard-level delivery failure."""


def _rng(seed: int, *scope) -> np.random.Generator:
    """Deterministic generator keyed by (seed, scope ids).  Strings enter
    through crc32 so the key is stable across processes (unlike hash())."""
    ids = [int(seed) & 0xFFFFFFFF]
    for s in scope:
        if isinstance(s, str):
            ids.append(zlib.crc32(s.encode()) & 0xFFFFFFFF)
        else:
            ids.append(int(s) & 0xFFFFFFFF)
    return np.random.default_rng(np.random.SeedSequence(ids))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Reproducible chaos recipe.  All probabilities in [0, 1]; a plan of
    all zeros injects nothing."""
    seed: int = 0
    drop: float = 0.0                  # P(shard permanently dead)
    drop_shards: Tuple[int, ...] = ()  # explicit permanently-dead shards
    flaky: float = 0.0                 # P(one attempt fails, transient)
    delay: float = 0.0                 # P(shard is a straggler)
    delay_seconds: float = 0.05        # straggler sleep before delivery
    duplicate: float = 0.0             # P(a chunk is delivered twice)
    corrupt: float = 0.0               # P(a chunk / state gets a bit flip)

    def __post_init__(self):
        for f in ("drop", "flaky", "delay", "duplicate", "corrupt"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultPlan.{f} must be in [0, 1], "
                                 f"got {v}")
        if self.delay_seconds < 0:
            raise ValueError("FaultPlan.delay_seconds must be >= 0")

    def is_dropped(self, shard: int) -> bool:
        """Permanent death, keyed by shard only: every attempt sees the
        same verdict."""
        if shard in self.drop_shards:
            return True
        return self.drop > 0 and \
            _rng(self.seed, "drop", shard).random() < self.drop

    def is_flaky(self, shard: int, attempt: int) -> bool:
        """Transient failure, keyed by (shard, attempt): a retried attempt
        rolls again and can succeed."""
        return self.flaky > 0 and \
            _rng(self.seed, "flaky", shard, attempt).random() < self.flaky

    def delay_for(self, shard: int) -> float:
        """Straggler sleep for this shard (0.0 = on time)."""
        if self.delay > 0 and \
                _rng(self.seed, "delay", shard).random() < self.delay:
            return self.delay_seconds
        return 0.0

    def chunk_events(self, shard: int, chunk: int) -> Tuple[bool, bool]:
        """(duplicate?, corrupt?) for one delivered chunk."""
        dup = self.duplicate > 0 and \
            _rng(self.seed, "dup", shard, chunk).random() < self.duplicate
        cor = self.corrupt > 0 and \
            _rng(self.seed, "cor", shard, chunk).random() < self.corrupt
        return dup, cor


def flip_bit(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Copy of ``arr`` with exactly one bit flipped (bit rot in transit).
    Empty arrays pass through unchanged."""
    a = np.array(arr, copy=True)
    if a.nbytes == 0:
        return a
    raw = a.view(np.uint8).reshape(-1)
    pos = int(rng.integers(0, raw.size))
    raw[pos] ^= np.uint8(1 << int(rng.integers(0, 8)))
    return a


def corrupt_state(state, seed: int, shard: int = 0):
    """Flip one bit of a ``stream.IngestState``: the wire corruption the
    collector's digest check exists to catch.  The state's arrays are
    taken in the reference's pytree order and dtypes
    (``stream.state_leaves``) and the first non-empty one is hit, the
    float32 sketch table, so a seed flips the bit the reference's
    ``corrupt_state`` flips.  The result lies on the state's device."""
    from repro_torch.core import stream

    leaves = stream.state_leaves(state)
    rng = _rng(seed, "state", shard)
    for i, a in enumerate(leaves):
        if a.nbytes:
            leaves[i] = flip_bit(a, rng)
            break
    return stream.state_from_leaves(leaves, state.sketch.table.device)


def chaos_chunks(plan: FaultPlan, shard: int,
                 chunks: Iterable[np.ndarray], *,
                 attempt: int = 0) -> Iterator[np.ndarray]:
    """Wrap one shard's chunk stream with the plan's faults.

    A dropped shard raises :class:`ShardFailure` before yielding anything
    (all-or-nothing delivery); a flaky attempt raises likewise; a
    straggler sleeps once up front; surviving chunks are then duplicated
    or bit-flipped as the plan says."""
    if plan.is_dropped(shard):
        raise ShardFailure(f"shard {shard}: injected permanent drop")
    if plan.is_flaky(shard, attempt):
        raise ShardFailure(
            f"shard {shard}: injected transient failure (attempt {attempt})")
    d = plan.delay_for(shard)
    if d > 0:
        time.sleep(d)
    for i, c in enumerate(chunks):
        dup, cor = plan.chunk_events(shard, i)
        if cor:
            c = flip_bit(np.asarray(c), _rng(plan.seed, "corbits", shard, i))
        yield c
        if dup:
            yield c


def chaos_make_batch(plan: FaultPlan, make_batch: Callable) -> Callable:
    """Wrap a loader's ``make_batch(shard, batch_idx)``: dropped shards
    raise on every batch, stragglers sleep on their first batch, corrupt
    batches get one bit flipped.  (Duplicates are a delivery fault that
    ``make_batch`` cannot express: use :func:`chaos_chunks`.)"""
    def wrapped(shard: int, b: int):
        if plan.is_dropped(shard):
            raise ShardFailure(f"shard {shard}: injected permanent drop")
        if plan.is_flaky(shard, b):
            raise ShardFailure(
                f"shard {shard}: injected transient failure (batch {b})")
        if b == 0:
            d = plan.delay_for(shard)
            if d > 0:
                time.sleep(d)
        out = make_batch(shard, b)
        _, cor = plan.chunk_events(shard, b)
        if cor:
            out = flip_bit(np.asarray(out),
                           _rng(plan.seed, "corbits", shard, b))
        return out
    return wrapped


def chaos_shard_job(plan: FaultPlan, shard: int, fn: Callable[[], object]
                    ) -> Callable[[], object]:
    """Wrap a whole shard job (as ``resilience.collect_shards`` runs it).
    The wrapper counts its own calls, so the retry loop walks the
    (shard, attempt) decisions: permanent drops fail every attempt, flaky
    ones roll again.

    When the job returns a ``(state, digest)`` pair and the corruption
    roll hits, the state is bit-flipped after the digest was taken:
    exactly the in-flight corruption ``verify=True`` detects."""
    counter = [0]

    def wrapped():
        attempt = counter[0]
        counter[0] += 1
        if plan.is_dropped(shard):
            raise ShardFailure(f"shard {shard}: injected permanent drop")
        if plan.is_flaky(shard, attempt):
            raise ShardFailure(f"shard {shard}: injected transient failure "
                               f"(attempt {attempt})")
        d = plan.delay_for(shard)
        if d > 0:
            time.sleep(d)
        out = fn()
        _, cor = plan.chunk_events(shard, attempt)
        if cor and isinstance(out, tuple) and len(out) == 2:
            out = (corrupt_state(out[0], plan.seed, shard), out[1])
        return out
    return wrapped


def corrupt_file(path, seed: int = 0, mode: str = "flip",
                 truncate_frac: float = 0.5) -> None:
    """Damage a file on disk the way crashes and bit rot do.

    ``mode="flip"`` flips one deterministic bit in place (silent
    corruption: the file still opens, the checksum catches it);
    ``mode="truncate"`` cuts the file to ``truncate_frac`` of its size (a
    torn write: the container itself fails to parse)."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path!r}")
    rng = _rng(seed, "file", os.path.basename(path))
    if mode == "flip":
        pos = int(rng.integers(0, size))
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * truncate_frac)))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"use 'flip' or 'truncate'")
