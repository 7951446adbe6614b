"""The port's cloud-in-cell splat (K2) and gather (K3) and the COO
dedupe of the sparse tSNE P, against the JAX reference on the CPU.  The
CUDA kernels themselves are held to these plain versions in
test_torch_cuda_kernels.py.

Tolerances:

* ``coo.dedupe_edges``: bit-identical on kNN-built edge lists (a pair
  occurs at most twice, and a two-term sum has one result in any order).
* splat and gather: the twins against the reference's XLA loops
  (``_splat_xla`` / ``_gather_xla``) and its Pallas kernels in interpret
  mode, within 1e-5 of the total mass Σ|v| (XLA and the interpret
  kernel's one-hot matmuls sum the corner products in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coo as ref_coo
from repro.core import neighbors as ref_neighbors
from repro.core import tsne as ref_tsne
from repro.kernels import ops as ref_ops
from repro_torch.core import coo, tsne
from repro_torch.kernels import LAUNCHES, cic


def _points(n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2)) * scale).astype(np.float32)


@pytest.mark.parametrize("n,k", [(60, 5), (300, 12)])
def test_dedupe_edges_bit_identical_on_knn_edges(n, k):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    idx, _ = ref_neighbors.knn_graph(jnp.asarray(x), k)
    idx = np.asarray(idx)
    vals = rng.uniform(0, 1, size=n * k).astype(np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    cols = idx.reshape(-1).astype(np.int32)
    src = np.concatenate([rows, cols])
    dst = np.concatenate([cols, rows])
    val = np.concatenate([0.5 * vals, 0.5 * vals])
    rs, rd, rv = ref_coo.dedupe_edges(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(val))
    ts, td, tv = coo.dedupe_edges(torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(val))
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())
    np.testing.assert_array_equal(np.asarray(rd), td.numpy())
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    assert (tv.numpy() == 0).any()          # mutual neighbours folded


@pytest.mark.parametrize("g", [8, 64])
def test_cic_weights_match_reference(g):
    y = _points(200, g)
    ri, rf, rh = ref_tsne._cic_weights(jnp.asarray(y), g)
    ti, tf, th = tsne._cic_weights(torch.from_numpy(y), g)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    np.testing.assert_allclose(np.asarray(rf), tf.numpy(), rtol=0, atol=1e-6)
    assert float(rh) == th.item()
    assert ti.min() >= 0 and ti.max() <= g - 2


@pytest.mark.parametrize("n,g,block", [(100, 16, 32), (257, 64, 128),
                                       (40, 4, 16)])
def test_splat_and_gather_twins_match_reference(n, g, block):
    y = _points(n, n + g)
    i0, f, _ = ref_tsne._cic_weights(jnp.asarray(y), g)
    rng = np.random.default_rng(g)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    got = cic.cic_splat_torch(torch.from_numpy(np.array(i0)),
                              torch.from_numpy(np.array(f)),
                              torch.from_numpy(vals), g).numpy()
    xla = np.asarray(ref_tsne._splat_xla(i0, f, jnp.asarray(vals.T), g))
    pal = np.asarray(ref_ops.cic_splat(i0, f, jnp.asarray(vals), g,
                                       block_items=block, interpret=True))
    tol = 1e-5 * float(np.abs(vals).sum())
    assert got.shape == (3, g, g)
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pal, rtol=0, atol=tol)

    fields = rng.normal(size=(4, g, g)).astype(np.float32)
    got = cic.cic_gather_torch(torch.from_numpy(fields),
                               torch.from_numpy(np.array(i0)),
                               torch.from_numpy(np.array(f))).numpy()
    xla = np.asarray(ref_tsne._gather_xla(jnp.asarray(fields), i0, f)).T
    pal = np.asarray(ref_ops.cic_gather(jnp.asarray(fields), i0, f,
                                        block_items=block, interpret=True))
    tol = 1e-5 * float(np.abs(fields).sum())
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pal, rtol=0, atol=tol)


def test_zero_mass_rows_splat_nothing():
    """The reference's padding contract: rows of zero mass add nothing."""
    i0 = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    f = torch.tensor([[0.25, 0.5], [0.5, 0.5]])
    vals = torch.tensor([[2.0], [0.0]])
    grid = cic.cic_splat(i0, f, vals, 4)
    assert grid.sum().item() == 2.0
    assert grid[0, 0, 0].item() == 0.0 and grid[0, 1, 2].item() == 0.75


def test_cpu_tensors_take_the_twins_and_cuda_wrappers_raise():
    y = torch.from_numpy(_points(50, 1))
    i0, f, _ = tsne._cic_weights(y, 16)
    vals = torch.ones((50, 3))
    fields = torch.ones((3, 16, 16))
    before = (LAUNCHES["cic_splat"], LAUNCHES["cic_gather"])
    assert torch.equal(cic.cic_splat(i0, f, vals, 16),
                       cic.cic_splat_torch(i0, f, vals, 16))
    assert torch.equal(cic.cic_gather(fields, i0, f),
                       cic.cic_gather_torch(fields, i0, f))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cic.cic_splat_cuda(i0, f, vals, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cic.cic_gather_cuda(fields, i0, f)
    assert (LAUNCHES["cic_splat"], LAUNCHES["cic_gather"]) == before
