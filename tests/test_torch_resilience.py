"""Retries, straggler cutoff and partial aggregation
(repro_torch.core.resilience) against the JAX reference's
``repro.core.resilience``, on the CPU.

The shard jobs of both packages fold the same chunks with the same hash
parameters (the reference's draws, carried as numpy), so the merged
states are compared bit for bit; coverage, lost mass and the widened
bound must be equal floats."""
import re
import threading

import numpy as np
import pytest

from _torch_parity import hash_params
from repro.core import geo as ref_geo
from repro.core import quantize as ref_quantize
from repro.core import resilience as ref_res
from repro.core import stream as ref_stream
from repro.core.faults import FaultPlan as RefPlan
from repro_torch import carry
from repro_torch.core import faults, geo, quantize, resilience, stream

ROWS, LOG2_COLS, POOL = 4, 10, 256
N_SHARDS, PER_SHARD, DIMS = 6, 300, 3
FAST = dict(max_attempts=3, base_delay=0.001, max_delay=0.01)


def _shard_data():
    rng = np.random.RandomState(0)
    return {s: [(rng.randn(PER_SHARD, DIMS) * 0.05
                 + (s % 3)).astype(np.float32)]
            for s in range(N_SHARDS)}


@pytest.fixture(scope="module")
def grids():
    g = ref_quantize.fit_grid(
        np.concatenate([c for v in _shard_data().values() for c in v]), 8)
    return g, quantize.GridSpec(dims=g.dims, bins=g.bins, lo=g.lo, hi=g.hi)


def _jobs(grids, data, plan=None, **kw):
    """(port jobs, reference jobs) over the same data and plan."""
    ref_grid, grid = grids
    common = dict(seed=0, rows=ROWS, log2_cols=LOG2_COLS, pool=POOL,
                  chunk_size=128)
    mine = geo.shard_ingest_jobs(
        grid, data, faults=None if plan is None else faults.FaultPlan(**plan),
        device="cpu",
        hash_params=carry.hash_params_from_numpy(*hash_params(0, ROWS)),
        **common, **kw)
    ref = ref_geo.shard_ingest_jobs(
        ref_grid, data, faults=None if plan is None else RefPlan(**plan),
        **common, **kw)
    return mine, ref


def _collect(grids, data, plan=None, **kw):
    mine, ref = _jobs(grids, data, plan)
    a = resilience.collect_shards(mine, policy=resilience.RetryPolicy(**FAST),
                                  verify=True, device="cpu", **kw)
    b = ref_res.collect_shards(ref, policy=ref_res.RetryPolicy(**FAST),
                               verify=True, **kw)
    return a, b


def _assert_agg_equal(a, b):
    assert stream.state_digest(a.state) == ref_stream.state_digest(b.state)
    for f in ("observed_count", "expected_count", "coverage", "lost_mass",
              "hh_error_bound", "lost", "retries"):
        assert getattr(a, f) == getattr(b, f), f
    assert [(s.shard, s.ok, s.attempts) for s in a.statuses] == \
        [(s.shard, s.ok, s.attempts) for s in b.statuses]


BAD_POLICIES = [dict(max_attempts=0), dict(base_delay=-1.0),
                dict(multiplier=0.5), dict(jitter=1.5),
                dict(attempt_timeout=0.0),
                dict(retryable_exceptions=(ValueError, "x"))]


@pytest.mark.parametrize("bad", BAD_POLICIES)
def test_policy_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        ref_res.RetryPolicy(**bad)
    with pytest.raises(ValueError) as mine:
        resilience.RetryPolicy(**bad)
    assert str(mine.value) == str(ref.value)


def test_backoff_and_latency_buckets_equal_the_reference():
    for kw in (dict(), dict(base_delay=0.05, multiplier=3.0, max_delay=0.4,
                            jitter=0.9), dict(jitter=0.0)):
        p, r = resilience.RetryPolicy(**kw), ref_res.RetryPolicy(**kw)
        for attempt in range(6):
            for seed in (0, 3, 2 ** 32 + 5):
                assert p.backoff(attempt, seed) == r.backoff(attempt, seed)
    secs = [0.0, 0.001, 0.0011, 0.05, 0.1, 0.5, 1.0, 9.9, 10.0, 11.0, 1e4]
    assert resilience.latency_histogram(secs) == \
        ref_res.latency_histogram(secs)
    assert resilience.LATENCY_BUCKET_LABELS == ref_res.LATENCY_BUCKET_LABELS
    assert resilience.widened_bound(2.0, 5.5) == ref_res.widened_bound(2.0,
                                                                       5.5)


def _outcome(mod, fn, **kw):
    try:
        out, used = mod.call_with_retry(
            fn, mod.RetryPolicy(**FAST, **kw.pop("policy", {})), **kw)
        return ("ok", out, used)
    except Exception as e:                               # noqa: BLE001
        return (type(e).__name__, re.sub(r"0x[0-9a-f]+", "", str(e)))


def _flaky(fails, exc=RuntimeError):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise exc(f"transient {calls[0]}")
        return calls[0]
    return fn


def test_call_with_retry_outcomes_equal_the_reference():
    from repro.core.stream import CheckpointCorruptError as RefCorrupt
    cases = [
        lambda m: dict(fn=_flaky(2)),
        lambda m: dict(fn=_flaky(5)),
        lambda m: dict(fn=_flaky(1, ValueError)),
        lambda m: dict(fn=_flaky(1, KeyError), policy=dict(
            retryable_exceptions=(RuntimeError,))),
        lambda m: dict(fn=_flaky(1, ValueError), policy=dict(
            non_retryable_exceptions=())),
        lambda m: dict(fn=_flaky(0), check=_flaky(1, m.IntegrityError)),
    ]
    for case in cases:
        assert _outcome(resilience, **case(resilience)) == \
            _outcome(ref_res, **case(ref_res))
    # each package's own CheckpointCorruptError is non-retryable
    for mod, exc in ((resilience, stream.CheckpointCorruptError),
                     (ref_res, RefCorrupt)):
        fn = _flaky(1, exc)
        with pytest.raises(exc):
            mod.call_with_retry(fn, mod.RetryPolicy(**FAST))
    laps = []
    resilience.call_with_retry(_flaky(2), resilience.RetryPolicy(**FAST),
                               on_attempt=lambda a, s, e: laps.append(
                                   (a, e is None)))
    assert laps == [(0, False), (1, False), (2, True)]


def test_healthy_collection_is_one_fold_of_the_whole_stream(grids):
    data = _shard_data()
    a, b = _collect(grids, data)
    _assert_agg_equal(a, b)
    assert a.coverage == 1.0 and a.lost == () and a.retries == 0
    # every chunk fits the pool, so the merge is bit for bit one fold of
    # the concatenated stream
    one = stream.ingest_all(
        stream.init(carry.hash_params_from_numpy(*hash_params(0, ROWS)),
                    LOG2_COLS, POOL),
        grids[1], [c for s in data for c in data[s]], 128)
    assert float(one.evict_max) == 0.0
    assert stream.state_digest(a.state) == stream.state_digest(one)


@pytest.mark.parametrize("plan,kw", [
    (dict(seed=1, flaky=0.5), {}),
    (dict(seed=1, drop_shards=(1, 4), flaky=0.3), {}),
    (dict(seed=2, drop_shards=(0,)), dict(expected_counts={
        s: float(PER_SHARD) for s in range(N_SHARDS)})),
    (dict(seed=0, corrupt=0.5, duplicate=0.3), {}),
])
def test_faulty_collections_equal_the_reference(grids, plan, kw):
    """Flaky shards are rescued, drops degrade with the reference's
    coverage, lost mass and widened bound, corrupt deliveries are caught
    by the digest and retried."""
    a, b = _collect(grids, _shard_data(), plan, **kw)
    _assert_agg_equal(a, b)
    if plan.get("flaky") == 0.5:
        assert a.retries >= 1 and a.lost == ()
    if "drop_shards" in plan:
        assert set(plan["drop_shards"]) <= set(a.lost) and a.coverage < 1.0
    if plan.get("corrupt"):
        assert a.retries >= 1


def test_coverage_floor_and_zero_survivors_fail_loud(grids):
    data = _shard_data()
    for plan, kw in ((dict(drop_shards=(0, 1, 2)), dict(min_coverage=0.9)),
                     (dict(drop=1.0), {})):
        mine, ref = _jobs(grids, data, plan)
        with pytest.raises(ref_res.CoverageError) as r:
            ref_res.collect_shards(ref, policy=ref_res.RetryPolicy(**FAST),
                                   verify=True, **kw)
        with pytest.raises(resilience.CoverageError) as m:
            resilience.collect_shards(
                mine, policy=resilience.RetryPolicy(**FAST), verify=True,
                device="cpu", **kw)
        strip = (lambda s: re.sub(r"\d+\.\d+e?-?\d*s", "", s))
        assert strip(str(m.value)) == strip(str(r.value))
    with pytest.raises(ValueError, match="min_coverage"):
        resilience.collect_shards({}, min_coverage=1.5, device="cpu")


def test_deadline_abandons_a_straggler_then_it_drains(grids):
    """The straggler waits on an Event the test releases, not on a sleep:
    the healthy shards (warmed first) deliver, the straggler is cut off
    at the deadline and counted lost, then released and drained."""
    data = _shard_data()
    mine, _ = _jobs(grids, data)
    for s in (0, 1):
        mine[s]()                                        # warm the fold
    gate, done = threading.Event(), threading.Event()
    slow = mine[2]

    def straggler():
        gate.wait(60.0)
        try:
            return slow()
        finally:
            done.set()
    jobs = {0: mine[0], 1: mine[1], 2: straggler}
    agg = resilience.collect_shards(
        jobs, policy=resilience.RetryPolicy(**FAST), verify=True,
        deadline=5.0, device="cpu")
    gate.set()
    assert done.wait(60.0)
    assert agg.lost == (2,) and agg.statuses[2].error == "deadline"
    assert agg.coverage == pytest.approx(2 / 3)
    assert agg.hh_error_bound == pytest.approx(PER_SHARD)
    assert [s.ok for s in agg.statuses] == [True, True, False]
