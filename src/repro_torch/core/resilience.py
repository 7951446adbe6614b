"""Fault tolerance for distributed ingest: retries, straggler cutoff,
partial aggregation.

The CountSketch is linear (merge = add), so partial aggregation is the
principled answer to shard loss: merging the sketches that did arrive
gives exactly the sketch of the surviving sub-stream, and the damage is
quantifiable: the observed share of the mass (``coverage``) and a
widened heavy-hitter error bound (a lost shard could have put all its
mass on one cell).  Host code (numpy and threads), a copy of the
reference's ``repro.core.resilience`` over the port's ``core.stream``:

* :class:`RetryPolicy` — bounded attempts, exponential backoff with
  deterministic seed-keyed jitter, optional per-attempt timeout;
  :func:`call_with_retry` drives it, :class:`RetryError` carries the last
  failure after exhaustion.
* :func:`collect_shards` — per-shard jobs run concurrently, each in its
  own retry loop; a global ``deadline`` abandons stragglers; the states
  that arrived move to the master's device and merge through
  ``stream.merge_states``; optional digest verification rejects
  corrupted deliveries (they count as failed attempts and retry).
* :class:`PartialAggregate` — merged state + ``coverage`` +
  ``hh_error_bound`` + each shard's :class:`ShardStatus`.
  ``min_coverage`` is the fail-loud floor.

What retries, what degrades, what fails loud:

* transient failures (flaky attempts, corrupted deliveries) → RETRIED,
  up to ``RetryPolicy.max_attempts`` a shard;
* permanent shard loss, deadline stragglers → DEGRADE: partial
  aggregation with ``coverage < 1`` and a widened ``hh_error_bound``
  (monotone: losing more shards never shrinks it);
* ``coverage < min_coverage`` or no surviving shard → FAIL LOUD
  (:class:`CoverageError` listing every shard's fate).

On the card the jobs run in threads on one device: each thread's work is
ordered on its own current stream, each job ships its state as CPU
tensors, and the master moves the survivors to ``device`` before the
merge.  A straggler cut off by the deadline is abandoned, not killed: its
thread may still be running when the collector returns.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device import resolve_device


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last failure."""


class IntegrityError(RuntimeError):
    """A delivered payload failed its digest check (bit rot in transit)."""


class CoverageError(RuntimeError):
    """Partial aggregation fell below the configured coverage floor."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``backoff(attempt)`` for attempt = 0, 1, ... is
    ``min(base * multiplier**attempt, max_delay)`` scaled by a jitter
    factor drawn deterministically from ``(seed, attempt)``.
    ``attempt_timeout`` bounds one attempt's wall clock (the attempt's
    thread is abandoned, not killed).

    ``retryable_exceptions`` is the allowlist; anything matching
    ``non_retryable_exceptions`` fails at once even if it also matches
    the allowlist (deny wins).  ``non_retryable_exceptions=None`` means
    the default deny set: ``ValueError`` and
    ``stream.CheckpointCorruptError``, failures that replaying cannot
    cure."""
    max_attempts: int = 3
    base_delay: float = 0.01
    multiplier: float = 2.0
    max_delay: float = 1.0
    jitter: float = 0.5                    # delay *= 1 ± U(0, jitter)
    attempt_timeout: Optional[float] = None
    retryable_exceptions: Tuple[type, ...] = (Exception,)
    non_retryable_exceptions: Optional[Tuple[type, ...]] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RetryPolicy.max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("RetryPolicy delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("RetryPolicy.multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("RetryPolicy.jitter must be in [0, 1]")
        if self.attempt_timeout is not None and self.attempt_timeout <= 0:
            raise ValueError("RetryPolicy.attempt_timeout must be > 0")
        for name in ("retryable_exceptions", "non_retryable_exceptions"):
            excs = getattr(self, name)
            if excs is None:
                continue
            if not all(isinstance(e, type) and issubclass(e, BaseException)
                       for e in excs):
                raise ValueError(
                    f"RetryPolicy.{name} must be a tuple of exception "
                    f"types, got {excs!r}")

    def is_retryable(self, exc: BaseException) -> bool:
        """Should ``exc`` consume another attempt?  The deny list wins
        over the allow list."""
        deny = self.non_retryable_exceptions
        if deny is None:
            from repro_torch.core.stream import CheckpointCorruptError
            deny = (ValueError, CheckpointCorruptError)
        if isinstance(exc, deny):
            return False
        return isinstance(exc, self.retryable_exceptions)

    def backoff(self, attempt: int, seed: int = 0) -> float:
        """Sleep before retry number ``attempt+1`` (deterministic)."""
        d = min(self.base_delay * self.multiplier ** attempt,
                self.max_delay)
        if self.jitter > 0:
            u = np.random.default_rng(
                np.random.SeedSequence([seed & 0xFFFFFFFF, attempt])
            ).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d


def _timed_call(fn: Callable[[], object], timeout: Optional[float]):
    """Run ``fn`` with a wall-clock bound.  A timeout abandons the
    attempt's thread; its result, if it ever comes, is dropped."""
    if timeout is None:
        return fn()
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fn)
        return fut.result(timeout=timeout)
    except TimeoutError:
        raise TimeoutError(f"attempt exceeded {timeout}s") from None
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def call_with_retry(fn: Callable[[], object],
                    policy: Optional[RetryPolicy] = None, *,
                    seed: int = 0,
                    check: Optional[Callable[[object], None]] = None,
                    on_retry: Optional[Callable[[int, Exception], None]] = None,
                    on_attempt: Optional[
                        Callable[[int, float, Optional[Exception]], None]]
                    = None) -> Tuple[object, int]:
    """Call ``fn`` under ``policy``; returns ``(result, attempts_used)``.

    ``check(result)`` validates a delivery: raising (e.g.
    :class:`IntegrityError` on a digest mismatch) counts as a failed
    attempt.  A failure the policy classes as non-retryable re-raises at
    once.  ``on_attempt(attempt, seconds, exc_or_None)`` observes every
    attempt's wall clock.  After the last retryable failure a
    :class:`RetryError` chains the cause."""
    policy = policy or RetryPolicy()
    last: Optional[Exception] = None
    for attempt in range(policy.max_attempts):
        t_a = time.monotonic()
        try:
            out = _timed_call(fn, policy.attempt_timeout)
            if check is not None:
                check(out)
            if on_attempt is not None:
                on_attempt(attempt, time.monotonic() - t_a, None)
            return out, attempt + 1
        except Exception as e:                           # noqa: BLE001
            last = e
            if on_attempt is not None:
                on_attempt(attempt, time.monotonic() - t_a, e)
            if not policy.is_retryable(e):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt + 1 < policy.max_attempts:
                time.sleep(policy.backoff(attempt, seed=seed))
    raise RetryError(
        f"all {policy.max_attempts} attempts failed; last: "
        f"{type(last).__name__}: {last}") from last


@dataclasses.dataclass
class ShardStatus:
    """One shard's fate through the collector."""
    shard: int
    ok: bool
    attempts: int            # attempts actually made (0 = never finished)
    seconds: float           # wall clock from submit to verdict
    error: Optional[str]     # final error ('deadline' for stragglers)
    # wall clock of each attempt, in order (a deadline straggler's attempt
    # in flight never reports)
    attempt_seconds: Tuple[float, ...] = ()


# log-spaced attempt-latency buckets (seconds, upper bounds; the last
# bucket is open), shared with the service's per-shard histograms
LATENCY_BUCKET_EDGES: Tuple[float, ...] = (0.001, 0.01, 0.1, 1.0, 10.0)
LATENCY_BUCKET_LABELS: Tuple[str, ...] = (
    "<=1ms", "<=10ms", "<=100ms", "<=1s", "<=10s", ">10s")


def latency_bucket(seconds: float) -> int:
    """Index into :data:`LATENCY_BUCKET_LABELS` for one attempt."""
    for i, edge in enumerate(LATENCY_BUCKET_EDGES):
        if seconds <= edge:
            return i
    return len(LATENCY_BUCKET_EDGES)


def latency_histogram(attempt_seconds: Sequence[float]) -> List[int]:
    """Bucket counts (one per :data:`LATENCY_BUCKET_LABELS`) for a batch of
    attempt wall clocks."""
    counts = [0] * len(LATENCY_BUCKET_LABELS)
    for s in attempt_seconds:
        counts[latency_bucket(float(s))] += 1
    return counts


@dataclasses.dataclass
class PartialAggregate:
    """Merged survivors + the quantified damage."""
    state: object                    # merged stream.IngestState
    observed_count: float            # mass actually folded
    expected_count: float            # observed + (known or estimated) lost
    coverage: float                  # observed / expected  (1.0 = no loss)
    lost_mass: float                 # expected - observed
    hh_error_bound: float            # max survivor watermark + lost_mass
    statuses: List[ShardStatus]
    lost: Tuple[int, ...]            # shard ids that never delivered
    retries: int                     # extra attempts beyond the first, total

    @property
    def n_ok(self) -> int:
        return sum(1 for s in self.statuses if s.ok)


def widened_bound(survivor_bound: float, lost_mass: float) -> float:
    """Heavy-hitter error bound after shard loss: the survivors' own
    watermark plus the whole estimated lost mass (a lost shard could have
    put every point in one cell).  Additive in the lost mass, hence
    monotone under widening loss."""
    return float(survivor_bound) + float(lost_mass)


def collect_shards(jobs: Mapping[int, Callable[[], object]], *,
                   policy: Optional[RetryPolicy] = None,
                   deadline: Optional[float] = None,
                   min_coverage: float = 0.0,
                   expected_counts: Optional[Mapping[int, float]] = None,
                   verify: bool = False,
                   max_workers: Optional[int] = None,
                   device=None) -> PartialAggregate:
    """Gather per-shard ingest states with retries and a straggler cutoff,
    then partial-aggregate whatever arrived, on ``device`` (None = the
    card).

    ``jobs`` maps shard id → zero-argument callable returning a
    ``stream.IngestState`` built with SHARED hash params (the paper's
    same-hash-functions contract: ``stream.merge_states`` is linear only
    under it), or, with ``verify=True``, a ``(state, digest)`` pair with
    ``digest = stream.state_digest(state)`` taken at the source; a
    mismatch on arrival is bit rot in transit and retries.

    ``deadline`` (seconds, global): shards still out when it expires are
    abandoned as stragglers and count as lost.  ``expected_counts``
    (shard → expected mass) sharpens coverage and the widened bound;
    without it a lost shard's mass is the mean observed shard mass.
    ``min_coverage`` in [0, 1]: below it, the zero-survivor case
    included, :class:`CoverageError` is raised instead of degrading."""
    from repro_torch.core import stream as stream_mod

    if not 0.0 <= min_coverage <= 1.0:
        raise ValueError(f"min_coverage must be in [0, 1], "
                         f"got {min_coverage}")
    dev = resolve_device(device)
    policy = policy or RetryPolicy()

    def checker(out):
        if not verify:
            return
        if not (isinstance(out, tuple) and len(out) == 2):
            raise IntegrityError(
                "verify=True expects jobs to return (state, digest); "
                f"got {type(out).__name__}")
        state, digest = out
        got = stream_mod.state_digest(state)
        if int(got) != int(digest):
            raise IntegrityError(
                f"state digest mismatch: got {got:#010x}, "
                f"expected {int(digest):#010x}")

    def run_one(shard: int, fn: Callable[[], object]):
        """The whole retry loop of one shard; never raises: the verdict
        travels in the returned ShardStatus."""
        t0 = time.monotonic()
        laps: List[float] = []

        def lap(_attempt, secs, _exc):
            laps.append(secs)

        try:
            out, attempts = call_with_retry(fn, policy, seed=shard,
                                            check=checker, on_attempt=lap)
            state = out[0] if verify else out
            return state, ShardStatus(shard=shard, ok=True,
                                      attempts=attempts,
                                      seconds=time.monotonic() - t0,
                                      error=None,
                                      attempt_seconds=tuple(laps))
        except RetryError as e:
            return None, ShardStatus(shard=shard, ok=False,
                                     attempts=policy.max_attempts,
                                     seconds=time.monotonic() - t0,
                                     error=str(e),
                                     attempt_seconds=tuple(laps))
        except Exception as e:                           # noqa: BLE001
            # non-retryable: failed on the attempt that raised; degrade
            # like any lost shard
            return None, ShardStatus(shard=shard, ok=False,
                                     attempts=len(laps),
                                     seconds=time.monotonic() - t0,
                                     error=f"non-retryable "
                                           f"{type(e).__name__}: {e}",
                                     attempt_seconds=tuple(laps))

    start = time.monotonic()
    shards = list(jobs)
    ex = ThreadPoolExecutor(max_workers=max_workers
                            or min(32, max(1, len(shards))))
    futs: Dict[Future, int] = {
        ex.submit(run_one, s, jobs[s]): s for s in shards}
    try:
        remaining = None if deadline is None \
            else max(0.0, deadline - (time.monotonic() - start))
        done, pending = wait(futs, timeout=remaining)
    finally:
        # do not wait: abandoned stragglers may still be inside their
        # delays, which is the point of the cutoff
        ex.shutdown(wait=False, cancel_futures=True)

    states: Dict[int, object] = {}
    statuses: Dict[int, ShardStatus] = {}
    for fut in done:
        state, st = fut.result()
        statuses[st.shard] = st
        if st.ok:
            states[st.shard] = state
    for fut in pending:
        s = futs[fut]
        statuses[s] = ShardStatus(shard=s, ok=False, attempts=0,
                                  seconds=time.monotonic() - start,
                                  error="deadline")
    ordered = [statuses[s] for s in shards]
    lost = tuple(s for s in shards if not statuses[s].ok)
    retries = sum(max(0, st.attempts - 1) for st in ordered)

    if not states:
        raise CoverageError(
            "no shard delivered a sketch — nothing to aggregate; "
            + "; ".join(f"shard {st.shard}: {st.error}" for st in ordered))

    merged = None
    observed = 0.0
    survivor_bound = 0.0
    for s in shards:
        if s not in states:
            continue
        st = stream_mod.state_to(states[s], dev)
        observed += float(st.count)
        survivor_bound = max(survivor_bound, float(st.evict_max))
        merged = st if merged is None else stream_mod.merge_states(merged, st)

    n_ok = len(states)
    if expected_counts is not None:
        lost_mass = sum(float(expected_counts[s]) for s in lost)
    else:
        lost_mass = len(lost) * (observed / n_ok)
    expected = observed + lost_mass
    coverage = observed / expected if expected > 0 else 1.0

    agg = PartialAggregate(
        state=merged, observed_count=observed, expected_count=expected,
        coverage=coverage, lost_mass=lost_mass,
        hh_error_bound=widened_bound(survivor_bound, lost_mass),
        statuses=ordered, lost=lost, retries=retries)
    if coverage < min_coverage:
        raise CoverageError(
            f"coverage {coverage:.3f} below min_coverage "
            f"{min_coverage:.3f} (lost shards: {list(lost)}; "
            + "; ".join(f"shard {st.shard}: {st.error}"
                        for st in ordered if not st.ok) + ")")
    return agg
