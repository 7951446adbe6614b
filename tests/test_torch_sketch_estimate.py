"""K8 ``sketch_estimate_table``'s plain versions against the JAX reference,
on the CPU.

The port's K8 hashes, gathers and takes the median over rows in one
kernel; on CPU tensors its wrappers run the plain chain (``hashing.hashes``
→ the signed gather → ``median_rows``), which the card tests hold the
kernel to bit for bit.  Here that chain meets the reference on the same
hash parameters and tables: explicit keys (``sketch.estimate``,
``ops.sketch_estimate_mxu``) and the dense vector's implicit keys
(``tensor_sketch_estimate``, across chunk boundaries), R ∈ {1, 3, 8, 16},
tables holding zeros under both signs (and −0.0 cells), compared by int32
view, so signed zeros count.

One exception, the reference's own: its MXU kernel accumulates each
estimate into a +0.0 output block, so where ``sketch.estimate`` gives
−0.0 the MXU path gives +0.0.  Against it the port is held equal in
value everywhere and by int32 view wherever the estimate is not zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import hash_params
from repro.core import hashing as ref_hashing
from repro.core import sketch as ref_sketch
from repro.kernels import ops as ref_ops
from repro_torch import carry
from repro_torch.core import sketch, u64
from repro_torch.kernels import ops
from repro_torch.kernels import sketch_estimate as k8

ROWS = [1, 3, 8, 16]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _same_bits(ref, port, what=""):
    np.testing.assert_array_equal(_bits(ref), _bits(port.numpy()),
                                  err_msg=what)


def _sketches(rows, seed, l2c=9):
    """One table in both packages: small integers, so zeros sit under
    both signs and the medians tie, and a column in seven −0.0."""
    hp = hash_params(seed, rows)
    rng = np.random.default_rng(seed)
    table = rng.integers(-2, 3, size=(rows, 1 << l2c)).astype(np.float32)
    table[:, ::7] = -0.0
    ref = ref_sketch.CountSketch(
        table=jnp.asarray(table),
        params=ref_hashing.MulShiftParams(*map(jnp.asarray, hp)))
    port = sketch.CountSketch(table=torch.from_numpy(table),
                              params=carry.hash_params_from_numpy(*hp))
    return ref, port


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 64, size=n, dtype=np.uint64)
    keys[: n // 5] = keys[0]                       # duplicate queries
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("rows", ROWS)
def test_explicit_keys_match_reference(rows):
    ref, sk = _sketches(rows, rows)
    hi, lo = _keys(rows + 1, 700)
    thi, tlo = u64.from_numpy(hi), u64.from_numpy(lo)
    want = np.asarray(ref_sketch.estimate(ref, jnp.asarray(hi),
                                          jnp.asarray(lo)))
    assert (_bits(want) == _bits(-0.0)).any()      # signed zeros present
    got = sketch.estimate(sk, thi, tlo)
    _same_bits(want, got, "sketch.estimate")
    _same_bits(want, k8.estimate_torch(sk.table, sk.params, thi, tlo),
               "estimate_torch")
    mxu = ops.sketch_estimate_mxu(sk, thi, tlo)
    _same_bits(want, mxu, "ops.sketch_estimate_mxu")
    ref_mxu = np.asarray(ref_ops.sketch_estimate_mxu(
        ref, jnp.asarray(hi), jnp.asarray(lo), block_q=128, block_c=256))
    np.testing.assert_array_equal(ref_mxu, mxu.numpy())
    nz = ref_mxu != 0
    np.testing.assert_array_equal(_bits(ref_mxu)[nz], _bits(mxu.numpy())[nz])


@pytest.mark.parametrize("rows", ROWS)
def test_implicit_keys_match_reference_across_chunks(rows, monkeypatch):
    """tensor_sketch_estimate in chunks of 1 000 over 2 500 coordinates
    (a ragged last chunk), and a range starting past 0, against the
    reference's one-shot estimate."""
    monkeypatch.setattr(sketch, "TENSOR_CHUNK", 1000)
    ref, sk = _sketches(rows, 10 + rows)
    n = 2500
    want = np.asarray(ref_sketch.tensor_sketch_estimate(ref, n))
    _same_bits(want, sketch.tensor_sketch_estimate(sk, n), "chunked")
    start = 1234
    got = k8.estimate_range_torch(sk.table, sk.params, start, n - start)
    _same_bits(want[start:], got, "estimate_range_torch from 1234")
    out = torch.full((n,), 7.0)
    k8.estimate_range(sk.table, sk.params, start, out[start:])
    _same_bits(want[start:], out[start:], "estimate_range into a slice")
    assert bool((out[:start] == 7.0).all())


def test_wide_tables_match_reference():
    """R 300, past the rows the kernel's shared-memory paths hold (the
    card takes a warp a query there): the wrapper accepts it, and its
    plain twin equals the reference's ``sketch.estimate`` by int32 view."""
    ref, sk = _sketches(300, 300)
    hi, lo = _keys(301, 500)
    thi, tlo = u64.from_numpy(hi), u64.from_numpy(lo)
    want = np.asarray(ref_sketch.estimate(ref, jnp.asarray(hi),
                                          jnp.asarray(lo)))
    assert k8.MAX_ROWS < 300
    _same_bits(want, k8.estimate(sk.table, sk.params, thi, tlo), "estimate")
    _same_bits(want, sketch.estimate(sk, thi, tlo), "sketch.estimate")
    out = torch.full((500,), 7.0)
    k8.estimate_range(sk.table, sk.params, 11, out)
    _same_bits(np.asarray(ref_sketch.tensor_sketch_estimate(ref, 511))[11:],
               out, "estimate_range")


def test_plain_versions_refuse_what_the_kernel_refuses():
    _, sk = _sketches(3, 0)
    with pytest.raises(ValueError, match="2\\^32"):
        k8.estimate_range_torch(sk.table, sk.params, (1 << 32) - 5, 6)
    with pytest.raises(ValueError, match="power-of-two"):
        k8.estimate_torch(sk.table[:, :100], sk.params,
                          torch.zeros(4, dtype=torch.int64),
                          torch.zeros(4, dtype=torch.int64))
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k8.estimate_cuda(sk.table, sk.params, k, k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k8.estimate_range_cuda(sk.table, sk.params, 0, torch.empty(4))
