"""The port's segment reduce (kernel K1): the plain version against the
JAX reference's cumsum (``segment_reduce_xla``) and its Pallas kernel in
interpret mode, and ``coo.segment_reduce``'s dispatch by device.  The
CUDA kernel itself is held to the plain version in
test_torch_cuda_kernels.py.

Tolerances: bit-identical on integer-valued fp32 payloads (every partial
sum is exact); otherwise within 1e-6 of the payload's total magnitude
Σ|v|, the scale of a cumsum difference's rounding error (the plain
version accumulates its CPU cumsum in float64, XLA in float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_reduce as ref_segred
from repro_torch.core import coo
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import segment_reduce as segred


def _case(rows, fan, d, seed, integer):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 2 * fan + 1, size=rows) if fan else \
        np.zeros(rows, np.int64)
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    e = int(bounds[-1])
    shape = (e,) if d == 0 else (e, d)
    vals = (rng.integers(-1000, 1000, size=shape) if integer
            else rng.normal(size=shape)).astype(np.float32)
    return vals, bounds


CASES = [(1, 16, 2), (16, 0, 2), (64, 3, 2), (33, 9, 3), (40, 5, 0),
         (0, 3, 2), (200, 40, 1)]


@pytest.mark.parametrize("rows,fan,d", CASES)
@pytest.mark.parametrize("integer", [True, False])
def test_plain_matches_reference_tiers(rows, fan, d, integer):
    vals, bounds = _case(rows, fan, d, rows + fan + d, integer)
    got = segred.segment_reduce_torch(torch.from_numpy(vals),
                                      torch.from_numpy(bounds)).numpy()
    ref = np.asarray(ref_segred.segment_reduce_xla(jnp.asarray(vals),
                                                   jnp.asarray(bounds)))
    assert got.shape == ref.shape == (rows,) + vals.shape[1:]
    if rows:
        pal = np.asarray(ref_segred.segment_reduce_pallas(
            jnp.asarray(vals), jnp.asarray(bounds), rows_per_block=8,
            edge_chunk=16, interpret=True))
    else:
        pal = ref
    if integer:
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pal)
    else:
        tol = 1e-6 * max(float(np.abs(vals).sum()), 1.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        np.testing.assert_allclose(got, pal, rtol=0, atol=tol)


def test_empty_rows_and_1d_payload():
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0])
    bounds = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    assert coo.segment_reduce(vals, bounds).tolist() == [3.0, 0.0, 7.0]
    empty = coo.segment_reduce(torch.zeros(0), torch.zeros(1, dtype=torch.int32))
    assert empty.shape == (0,)


def test_row_bounds_and_edge_layout():
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(0, 20, size=100))
    dst = torch.from_numpy(rng.integers(0, 20, size=100))
    vals = torch.from_numpy(rng.integers(-9, 9, size=(100, 2)).astype(
        np.float32))
    lay, order = coo.edge_layout(src, dst, 20)
    v = vals[order]
    want_src = torch.zeros(20, 2).index_add_(0, src, vals)
    want_dst = torch.zeros(20, 2).index_add_(0, dst, vals)
    assert torch.equal(coo.segment_reduce(v, lay.src_bounds), want_src)
    assert torch.equal(coo.segment_reduce(v[lay.dst_order], lay.dst_bounds),
                       want_dst)
    assert torch.equal(lay.src, src[order])


def test_forcing_cuda_on_cpu_raises_and_nothing_falls_back():
    vals, bounds = torch.ones(4, 2), torch.tensor([0, 4], dtype=torch.int32)
    before = LAUNCHES["segment_reduce"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        segred.segment_reduce_cuda(vals, bounds)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segred.segment_reduce_cuda(vals[:, 0].contiguous(), bounds)
    assert LAUNCHES["segment_reduce"] == before


@pytest.mark.parametrize("d", [0, 2])
def test_cpu_tensors_take_the_plain_version(d):
    vals, bounds = _case(50, 6, d, 11, False)
    v, b = torch.from_numpy(vals), torch.from_numpy(bounds)
    before = LAUNCHES["segment_reduce"]
    assert torch.equal(coo.segment_reduce(v, b),
                       segred.segment_reduce_torch(v, b))
    assert LAUNCHES["segment_reduce"] == before


@pytest.mark.parametrize("n,e,lanes", [(46348, 695220, 8),
                                       (207759, 37396620, 32),
                                       (10, 0, 1), (10, 20, 1), (10, 21, 2),
                                       (10, 80, 4), (10, 81, 8),
                                       (0, 5, 4), (1, 10**6, 32)])
def test_group_lanes_from_shapes(n, e, lanes):
    """K1's lanes per row: the smallest power of two >= E / 2N, capped at
    a warp; 8 at the UMAP epoch's shapes, 32 at path S's."""
    assert segred.group_lanes(n, e) == lanes
