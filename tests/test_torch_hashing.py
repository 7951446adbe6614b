"""Parity of the port's keys and hashes (repro_torch.core.u64 / hashing /
quantize) with the JAX reference: bit-identical on the same inputs and
hash parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref_hashing
from repro.core import quantize as ref_quantize
from repro.core import u64 as ref_u64
from repro_torch import carry
from repro_torch.core import hashing, prng, quantize, u64

U32 = np.iinfo(np.uint32).max


def _limbs(rng, n):
    return rng.integers(0, U32, size=n, dtype=np.uint64, endpoint=True
                        ).astype(np.uint32)


def _t(a):
    return u64.from_numpy(a)


def _eq(ref, port):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  port.numpy())


def test_u64_ops_bit_identical():
    rng = np.random.default_rng(0)
    n = 4096
    ah, al, bh, bl, x = (_limbs(rng, n) for _ in range(5))
    # edge limbs: 0, 1 and 2**32-1 in every position
    for arr in (ah, al, bh, bl, x):
        arr[:3] = [0, 1, U32]
    a, b = (ah, al), (bh, bl)
    ta, tb = (_t(ah), _t(al)), (_t(bh), _t(bl))
    for ref, port in [
            (ref_u64.add(a, b), u64.add(ta, tb)),
            (ref_u64.add_u32(a, x), u64.add_u32(ta, _t(x))),
            (ref_u64.umul32_full(al, x), u64.umul32_full(_t(al), _t(x))),
            (ref_u64.mul_u32(a, x), u64.mul_u32(ta, _t(x))),
            *[(ref_u64.shl(a, s), u64.shl(ta, s)) for s in (0, 5, 31, 32, 45)],
            *[(ref_u64.shr(a, s), u64.shr(ta, s)) for s in (0, 5, 31, 32, 45)]]:
        _eq(ref[0], port[0])
        _eq(ref[1], port[1])
    # sort_key orders like the packed unsigned value
    packed = (ah.astype(np.uint64) << np.uint64(32)) | al
    np.testing.assert_array_equal(np.argsort(packed, kind="stable"),
                                  torch.sort(u64.sort_key(ta),
                                             stable=True)[1].numpy())


@pytest.mark.parametrize("log2", [1, 10, 18, 32])
def test_bucket_and_sign_hash_bit_identical(log2):
    rows = 16
    params = ref_hashing.make_params(jax.random.key(7), rows)
    port = carry.hash_params_from_numpy(*[np.asarray(p) for p in params])
    rng = np.random.default_rng(log2)
    hi, lo = _limbs(rng, 3000), _limbs(rng, 3000)
    hi[:2], lo[:2] = [0, U32], [0, U32]
    _eq(ref_hashing.bucket_hash(params, jnp.asarray(hi), jnp.asarray(lo),
                                log2),
        hashing.bucket_hash(port, _t(hi), _t(lo), log2))
    _eq(ref_hashing.sign_hash(params, jnp.asarray(hi), jnp.asarray(lo)),
        hashing.sign_hash(port, _t(hi), _t(lo)))


def test_make_params_draws_uint32_range():
    """The draw is the reference's: ``make_params(key(s), R)`` equals
    ``ref make_params(jax.random.key(s), R)`` bit for bit, each limb an
    int64 tensor holding uint32."""
    p = hashing.make_params(prng.key(3), 16)
    assert p.rows == 16
    for f in p:
        assert f.dtype == torch.int64 and f.shape == (16,)
        assert int(f.min()) >= 0 and int(f.max()) <= U32
    ref = ref_hashing.make_params(jax.random.key(3), 16)
    for a, b in zip(p, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))


@pytest.mark.parametrize("dims,bins", [(4, 8), (8, 25), (3, 2), (16, 16)])
def test_points_to_keys_bit_identical(dims, bins):
    """Covers keys that fit the low limb (4x3 bits), spill into the high
    limb (8x5 = 40 bits) and fill all 64 bits (16x4)."""
    rng = np.random.default_rng(dims * 100 + bins)
    pts = rng.normal(size=(2000, dims)).astype(np.float32)
    ref_grid = ref_quantize.fit_grid(jnp.asarray(pts), bins)
    grid = quantize.fit_grid(torch.from_numpy(pts), bins)
    assert (grid.lo, grid.hi, grid.bits_per_dim) == \
        (ref_grid.lo, ref_grid.hi, ref_grid.bits_per_dim)
    rk = ref_quantize.points_to_keys(ref_grid, jnp.asarray(pts))
    tk = quantize.points_to_keys(grid, torch.from_numpy(pts))
    _eq(rk[0], tk[0])
    _eq(rk[1], tk[1])
    _eq(ref_quantize.unpack(ref_grid, rk), quantize.unpack(grid, tk))
    coords = ref_quantize.unpack(ref_grid, rk)
    np.testing.assert_array_equal(
        np.asarray(ref_quantize.cell_center(ref_grid, coords)),
        quantize.cell_center(grid, quantize.unpack(grid, tk)).numpy())


def test_grid_rejects_too_many_bits():
    with pytest.raises(ValueError, match="cannot pack"):
        quantize.GridSpec(dims=17, bins=16, lo=[0.0] * 17, hi=[1.0] * 17)
