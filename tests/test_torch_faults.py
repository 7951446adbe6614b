"""Fault injection (repro_torch.core.faults) against the JAX reference's
``repro.core.faults``: the same plan and seed give the same decisions,
chunk sequences, flipped state bit and damaged file bytes."""
import itertools
import re

import jax
import numpy as np
import pytest

from _torch_parity import hash_params
from repro.core import faults as ref_faults
from repro.core import quantize as ref_quantize
from repro.core import stream as ref_stream
from repro_torch import carry
from repro_torch.core import faults, stream

PLANS = [dict(seed=7, drop=0.4, flaky=0.4, delay=0.4, duplicate=0.4,
              corrupt=0.4),
         dict(seed=3, drop_shards=(5,), flaky=0.5, delay_seconds=0.0),
         dict(seed=2 ** 33 + 1, duplicate=1.0, corrupt=0.25)]


@pytest.mark.parametrize("kw", PLANS)
def test_plan_decisions_equal_the_reference(kw):
    mine, ref = faults.FaultPlan(**kw), ref_faults.FaultPlan(**kw)
    for shard, attempt in itertools.product(range(12), range(4)):
        assert mine.is_dropped(shard) == ref.is_dropped(shard)
        assert mine.is_flaky(shard, attempt) == ref.is_flaky(shard, attempt)
        assert mine.delay_for(shard) == ref.delay_for(shard)
        assert mine.chunk_events(shard, attempt) == \
            ref.chunk_events(shard, attempt)


@pytest.mark.parametrize("bad", [dict(drop=1.5), dict(flaky=-0.1),
                                 dict(corrupt=2.0),
                                 dict(delay_seconds=-1.0)])
def test_plan_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        ref_faults.FaultPlan(**bad)
    with pytest.raises(ValueError) as mine:
        faults.FaultPlan(**bad)
    assert str(mine.value) == str(ref.value)


def _delivered(mod, plan_kw, shard, attempt):
    rng = np.random.default_rng(shard)
    chunks = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(6)]
    plan = mod.FaultPlan(**plan_kw)
    try:
        return [np.array(c) for c in mod.chaos_chunks(plan, shard, chunks,
                                                      attempt=attempt)]
    except mod.ShardFailure as e:
        return str(e)


@pytest.mark.parametrize("kw", PLANS)
def test_chaos_chunks_and_make_batch_equal_the_reference(kw):
    kw = dict(kw, delay_seconds=0.0)
    for shard, attempt in itertools.product(range(8), range(2)):
        mine = _delivered(faults, kw, shard, attempt)
        ref = _delivered(ref_faults, kw, shard, attempt)
        if isinstance(ref, str):
            assert mine == ref
            continue
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert a.tobytes() == b.tobytes()

    def make(shard, b):
        return np.full((4, 2), shard + 0.5 * b, np.float32)
    mb = faults.chaos_make_batch(faults.FaultPlan(**kw), make)
    rb = ref_faults.chaos_make_batch(ref_faults.FaultPlan(**kw), make)
    for shard, b in itertools.product(range(8), range(3)):
        try:
            want = rb(shard, b).tobytes()
        except ref_faults.ShardFailure as e:
            with pytest.raises(faults.ShardFailure, match=re.escape(str(e))):
                mb(shard, b)
            continue
        assert mb(shard, b).tobytes() == want


def test_corrupt_state_flips_the_reference_bit():
    """A reference fold carried across: corrupt_state flips the same bit
    (the table's, the first non-empty leaf), the digests equal the
    reference's before and after, and chaos_shard_job corrupts the state
    after the digest on the same attempts."""
    grid = ref_quantize.GridSpec(dims=3, bins=8, lo=(0.0,) * 3,
                                 hi=(1.0,) * 3)
    pts = np.random.default_rng(4).uniform(size=(700, 3)).astype(np.float32)
    ref = ref_stream.ingest_all(
        ref_stream.init(jax.random.key(0), 4, 8, 64), grid, [pts], 256)
    mine = carry.ingest_state_from_numpy(ref)
    assert stream.state_digest(mine) == ref_stream.state_digest(ref)
    for seed, shard in [(0, 0), (5, 3), (11, 7)]:
        bad_ref = ref_faults.corrupt_state(ref, seed, shard)
        bad = faults.corrupt_state(mine, seed, shard)
        assert stream.state_digest(bad) == ref_stream.state_digest(bad_ref)
        assert stream.state_digest(bad) != stream.state_digest(mine)
        diff = bad.sketch.table.numpy().view(np.uint32) ^ \
            mine.sketch.table.numpy().view(np.uint32)
        assert bin(int(np.bitwise_or.reduce(diff.ravel()))).count("1") == 1
        np.testing.assert_array_equal(
            bad.sketch.table.numpy().view(np.uint32),
            np.asarray(bad_ref.sketch.table).view(np.uint32))

    plan_kw = dict(seed=1, corrupt=0.5)
    job = faults.chaos_shard_job(faults.FaultPlan(**plan_kw), 2,
                                 lambda: (mine, stream.state_digest(mine)))
    ref_job = ref_faults.chaos_shard_job(
        ref_faults.FaultPlan(**plan_kw), 2,
        lambda: (ref, ref_stream.state_digest(ref)))
    for _ in range(6):
        (st, d), (rst, rd) = job(), ref_job()
        assert d == rd
        assert stream.state_digest(st) == ref_stream.state_digest(rst)


@pytest.mark.parametrize("mode,seed", [("flip", 0), ("flip", 9),
                                       ("truncate", 0)])
def test_corrupt_file_gives_the_reference_bytes(tmp_path, mode, seed):
    payload = np.random.default_rng(1).bytes(4099)
    for d in ("mine", "ref"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "ckpt.npz").write_bytes(payload)
    faults.corrupt_file(tmp_path / "mine" / "ckpt.npz", seed, mode)
    ref_faults.corrupt_file(tmp_path / "ref" / "ckpt.npz", seed, mode)
    got = (tmp_path / "mine" / "ckpt.npz").read_bytes()
    assert got == (tmp_path / "ref" / "ckpt.npz").read_bytes()
    assert got != payload
    with pytest.raises(ValueError, match="unknown corruption mode"):
        faults.corrupt_file(tmp_path / "mine" / "ckpt.npz", mode="melt")


def test_hash_params_carry_for_shard_jobs():
    """The shard jobs fold with the reference's hash parameters when
    given them: a carried state's params are the reference's draws."""
    hp = carry.hash_params_from_numpy(*hash_params(0, 4))
    st = stream.init(hp, 8, 64)
    ref = ref_stream.init(jax.random.key(0), 4, 8, 64)
    assert stream.state_digest(st) == ref_stream.state_digest(ref)
