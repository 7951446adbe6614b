"""The port's threefry (repro_torch.core.prng) against ``jax.random``,
and the cell-keyed replica jitter it draws, on the CPU.

Bars: keys, splits, folds and uniform draws bit-identical to
``jax.random`` (partitionable threefry, JAX's default), words at and
above 2**31 included; ``replicas.make_representatives`` with no jitter
fed bit-identical to the reference's under the same seed; and each
cell's points independent of the cell's row in the heavy-hitter list."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import replicas as ref_replicas
from repro_torch.core import prng, replicas
from repro_torch.core.heavy_hitters import HeavyHitters

SEEDS = [0, 5, 2**31 + 7, 2**32 - 1]
WORDS = np.array([0, 1, 3, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1],
                 np.uint32)


def _words(key):
    return [int(key[0]), int(key[1])]


def _jax_words(key):
    return np.asarray(jax.random.key_data(key)).tolist()


def test_jax_threefry_is_partitionable():
    """prng ports the partitionable split and bits; the reference's draws
    are those only under this flag."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    tk = prng.key(seed)
    assert _words(tk) == _jax_words(k)
    for num in (2, 3):
        want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
        got = [_words(s) for s in prng.split(tk, num)]
        assert got == want.tolist()
    # one key folded with many words at once, as make_representatives does
    want = np.stack([_jax_words(jax.random.fold_in(k, int(w)))
                     for w in WORDS])
    got = prng.fold_in(tk, torch.from_numpy(WORDS.astype(np.int64)))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want)


@pytest.mark.parametrize("shape,lo,hi", [((7, 3), -0.25, 0.25),
                                         ((8, 4), 0.0, 1.0),
                                         ((1,), -3.0, 5.5),
                                         ((5, 2, 3), -0.1, 0.1)])
def test_bits_and_uniform_match_jax(shape, lo, hi):
    for seed in SEEDS:
        k = jax.random.split(jax.random.key(seed))[0]
        tk = prng.split(prng.key(seed))[0]
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(k, shape)).astype(np.int64))
        want = np.asarray(jax.random.uniform(k, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(tk, shape, lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_batched_cell_keys_match_vmapped_jax():
    """fold_in over (K,) hi then lo words, then uniform per cell: the
    reference's vmap, against _torch_parity.replica_jitter."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**32, size=50, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, size=50, dtype=np.uint64).astype(np.uint32)
    hi[:3] = WORDS[-3:]
    want = par.replica_jitter(7, hi, lo, 8, 4, 0.25)
    key = prng.split(prng.key(8))[0]
    ck = prng.fold_in(prng.fold_in(key, torch.from_numpy(hi.astype(np.int64))),
                      torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(
        prng.uniform(ck, (8, 4), -0.25, 0.25).numpy(), want)


@pytest.mark.parametrize("dims,bins,scheme", [(4, 8, "count"),
                                              (8, 256, "count"),
                                              (8, 256, "uniform"),
                                              (3, 64, "rank")])
def test_representatives_match_reference_without_jitter(dims, bins, scheme):
    """No jitter fed: the port draws the reference's jitter itself, under
    pipeline.embed_stage's key, and every field is bit-identical
    (8 × log2 256 = 64 key bits: hi and lo words ≥ 2**31)."""
    grid, ref, tgrid, port = par.hh_case(dims + bins, dims=dims, bins=bins)
    seed = 11
    rr = ref_replicas.make_representatives(
        jax.random.split(jax.random.key(seed + 1))[0], grid, ref,
        scheme=scheme)
    tr = replicas.make_representatives(
        tgrid, port, scheme=scheme,
        key=prng.split(prng.key(seed + 1))[0])
    if bins == 256:
        assert int(port.key_hi.max()) >= 2**31
        assert int(port.key_lo.max()) >= 2**31
    for a, b in zip(tr, rr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_permuted_rows_keep_each_cells_points():
    """The same cells in another row order (a reshuffled ranking) and
    another count: each cell's replicas land where they did."""
    _, _, tgrid, port = par.hh_case(3, dims=6, bins=64)
    k, m = port.key_hi.shape[0], 8
    key = prng.split(prng.key(1))[0]
    a = replicas.make_representatives(tgrid, port, scheme="uniform",
                                      max_replicas=m, key=key)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(k))
    shuffled = HeavyHitters(port.key_hi[perm], port.key_lo[perm],
                            port.count[perm] * 3.0, port.mask[perm])
    b = replicas.make_representatives(tgrid, shuffled, scheme="uniform",
                                      max_replicas=m, key=key)
    pa = a.points.reshape(k, m, -1)
    pb = b.points.reshape(k, m, -1)
    assert torch.equal(pb, pa[perm])
    # a row-indexed draw would have moved them: the rows really moved
    assert not torch.equal(pb, pa)
    # and a different key moves every cell
    c = replicas.make_representatives(tgrid, port, scheme="uniform",
                                      max_replicas=m,
                                      key=prng.split(prng.key(2))[0])
    assert bool((c.points.reshape(k, m, -1) != pa).any(2).all())
