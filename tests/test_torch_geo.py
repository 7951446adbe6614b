"""The host tier of geo-distributed sketching (repro_torch.core.geo)
against the JAX reference's ``repro.core.geo`` on the CPU: per-site fold
jobs under a fault plan, collected, merged and extracted, give the
reference's heavy hitters bit for bit and its damage report."""
import numpy as np
import pytest

from _torch_parity import hash_params
from repro.core import geo as ref_geo
from repro.core import quantize as ref_quantize
from repro.core.faults import FaultPlan as RefPlan
from repro.core.resilience import RetryPolicy as RefPolicy
from repro_torch import carry
from repro_torch.core import faults, geo, quantize, resilience
from repro_torch.data.synthetic import MixtureSpec, clustered_points_sharded

N_SHARDS, PER_SHARD = 5, 400
KW = dict(rows=4, log2_cols=10, top_k=24, candidate_pool=160, seed=0,
          chunk_size=128, superbatch=2)
FAST = dict(max_attempts=4, base_delay=0.001, max_delay=0.01)


@pytest.fixture(scope="module")
def case():
    spec = MixtureSpec(dims=3, n_clusters=3, cluster_std=0.05,
                       background_frac=0.1)
    data = {s: clustered_points_sharded(s, PER_SHARD, spec, seed=2)
            for s in range(N_SHARDS)}
    g = ref_quantize.fit_grid(np.concatenate(list(data.values())), 6)
    return data, g, quantize.GridSpec(dims=3, bins=6, lo=g.lo, hi=g.hi)


def _sources(data):
    """Each shard as a factory of its chunks (re-read on a retry)."""
    return {s: (lambda p=p: iter([p[:150], p[150:]])) for s, p in data.items()}


@pytest.mark.parametrize("plan", [
    dict(seed=4, drop_shards=(2,), flaky=0.4, duplicate=0.3, corrupt=0.3),
    dict(seed=1, drop=0.3, flaky=0.3, corrupt=0.6),
])
def test_resilient_extract_equals_the_reference(case, plan):
    data, ref_grid, grid = case
    expected = {s: float(PER_SHARD) for s in data}
    ref = ref_geo.resilient_extract(
        ref_grid, _sources(data), policy=RefPolicy(**FAST),
        faults=RefPlan(**plan), expected_counts=expected, **KW)
    got = geo.resilient_extract(
        grid, _sources(data), policy=resilience.RetryPolicy(**FAST),
        faults=faults.FaultPlan(**plan), expected_counts=expected,
        device="cpu",
        hash_params=carry.hash_params_from_numpy(*hash_params(0, 4)), **KW)
    for a, b in zip(got.hh, ref.hh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.merged.table.numpy(),
                                  np.asarray(ref.merged.table))
    for f in ("observed_count", "coverage", "hh_error_bound", "lost",
              "retries"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.lost and got.retries >= 1 and got.coverage < 1.0
    assert [s.attempts for s in got.statuses] == \
        [s.attempts for s in ref.statuses]


def test_resilient_extract_guards(case):
    _, _, grid = case
    with pytest.raises(ValueError, match="at least one shard"):
        geo.resilient_extract(grid, {}, device="cpu", **KW)


@pytest.mark.parametrize("fn", [geo.sketch_shard, geo.geo_extract,
                                geo.geo_extract_from_shards])
def test_mesh_functions_raise_p12(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP P12"):
        fn(None, None, None)
