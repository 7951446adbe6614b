"""The port's exact tSNE backends against the JAX reference on the CPU:
calibration, dense P, and one gradient on every exact backend — the
port's dense, tiled and fused ("pallas": K5a tsne_z + K5b tsne_forces,
here their plain twins) against the reference's ``tsne_step_xla`` and its
Pallas kernels in interpret mode at block 128 — then whole pipeline runs.
The CUDA kernels are held to the twins in test_torch_cuda_kernels.py.

Tolerances:

* the bisection, given the same distances: beta rtol 1e-5 and zp rtol
  1e-4, as tests/test_sparse_tsne.py holds two calibrations to each
  other (entropies summed in other orders part in the last steps);
* ``calibrate_stats`` and ``p_from_stats`` end to end: rtol 1e-4.  Both
  take their distances from the fp32 Gram identity |a|² − 2a·b + |b|²,
  whose products XLA and torch's BLAS sum in other orders: on this
  fixture the two distance matrices part in the fifth significant digit
  (each is as far from the float64 distances), and beta inherits that;
* forces within 1e-4 of the largest force (tests/test_embed_backends.py's
  bar), the KL rtol 1e-5;
* the whole-run contract is in ``_torch_parity``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import tsne as ref_tsne
from repro.kernels import ops as ref_ops
from repro.kernels import tsne_forces as ref_tf
from repro_torch.core import tsne
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import tsne_forces as tf


def _fixture(n=300, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(4, d))
    x = np.concatenate([c + 0.3 * rng.normal(size=(n // 4, d))
                        for c in centers]).astype(np.float32)
    y = rng.normal(size=(x.shape[0], 2)).astype(np.float32)
    w = rng.uniform(1, 100, size=x.shape[0]).astype(np.float32)
    return x, y, w


def _stats(ref_stats):
    return tsne.PointStats(*[torch.from_numpy(np.array(a))
                             for a in ref_stats])


@pytest.mark.parametrize("perplexity", [5.0, 25.0])
def test_beta_search_matches_reference_given_the_same_distances(perplexity):
    x, _, _ = _fixture(seed=1)
    d2 = np.asarray(ref_tsne.pairwise_sq_dists(jnp.asarray(x)))
    neg_d = np.where(np.eye(len(x), dtype=bool), -np.inf, -d2)
    ref = np.asarray(ref_tsne._beta_search(
        jnp.asarray(neg_d), jnp.log(perplexity), 50))
    got = tsne._beta_search(torch.from_numpy(neg_d),
                            tsne._target_entropy(perplexity, "cpu"), 50)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    knn = np.sqrt(np.sort(d2 + np.diag(np.full(len(x), np.inf)), 1)[:, :30])
    ref = ref_tsne.calibrate_stats_knn(jnp.asarray(knn), perplexity)
    got = tsne.calibrate_stats_knn(torch.from_numpy(knn), perplexity)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-5)
    np.testing.assert_allclose(got.zp.numpy(), np.asarray(ref.zp), rtol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("block", [64, 512])
def test_calibrate_stats_matches_reference(weighted, block):
    x, _, w = _fixture(seed=1)
    wr = jnp.asarray(w) if weighted else None
    wt = torch.from_numpy(w) if weighted else None
    ref = ref_tsne.calibrate_stats(jnp.asarray(x), 25.0, weights=wr,
                                   block=block)
    got = tsne.calibrate_stats(torch.from_numpy(x), 25.0, weights=wt,
                               block=block)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-4)
    np.testing.assert_allclose(got.zp.numpy(), np.asarray(ref.zp), rtol=1e-4)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=1e-6)


def test_dense_p_and_kl_match_reference():
    x, y, w = _fixture(n=200, seed=2)
    stats = ref_tsne.calibrate_stats(jnp.asarray(x), 20.0,
                                     weights=jnp.asarray(w))
    ref_p = np.array(ref_tsne.p_from_stats(jnp.asarray(x), stats))
    got_p = tsne.p_from_stats(torch.from_numpy(x), _stats(stats))
    np.testing.assert_allclose(got_p.numpy(), ref_p, rtol=1e-4)
    ref_kl = float(ref_tsne.kl_divergence(jnp.asarray(ref_p),
                                          jnp.asarray(y)))
    got_kl = tsne.kl_divergence(torch.from_numpy(ref_p),
                                torch.from_numpy(y)).item()
    assert abs(got_kl - ref_kl) <= 1e-5 * abs(ref_kl)
    got = tsne.calibrate_p(torch.from_numpy(x), 20.0,
                           weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref_p, rtol=1e-4,
                               atol=1e-6 * ref_p.max())


@pytest.mark.parametrize("n", [300, 256])
@pytest.mark.parametrize("exag", [1.0, 12.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_exact_gradient_backends_match_reference(n, exag, weighted):
    """dense ≡ tiled ≡ fused twin ≡ the reference's tsne_step_xla and its
    interpret-mode kernel; N = 300 pads to 384 at block 128."""
    x, y, w = _fixture(n=n, seed=3)
    stats = ref_tsne.calibrate_stats(
        jnp.asarray(x), 30.0, weights=jnp.asarray(w) if weighted else None)
    args = (jnp.asarray(x), jnp.asarray(y), stats.beta, stats.zp)
    kw = dict(shift=stats.shift, weights=stats.w, exaggeration=exag,
              block=128, return_kl=True)
    refs = [ref_ops.tsne_step_fused(*args, mode="xla", **kw),
            ref_ops.tsne_step_fused(*args, interpret=True, **kw)]
    st = _stats(stats)
    got = [tsne.embedding_grad(torch.from_numpy(x), torch.from_numpy(y), st,
                               exag, backend=b, block=128)
           for b in ("dense", "tiled", "pallas")]
    for rg, rkl in refs:
        rg = np.asarray(rg)
        scale = np.abs(rg).max()
        for g, kl in got:
            assert g.shape == rg.shape
            assert np.abs(g.numpy() - rg).max() <= 1e-4 * scale
            assert abs(kl.item() - float(rkl)) <= 1e-5 * abs(float(rkl))


def test_fused_step_twins_match_reference_on_padded_rows():
    """tsne_step on the padded arrays: Z, forces and both KL partials
    against tsne_step_xla (padded rows get no force)."""
    x, y, w = _fixture(n=300, seed=4)
    stats = ref_tsne.calibrate_stats(jnp.asarray(x), 30.0,
                                     weights=jnp.asarray(w))
    spad = tf.step_stats(*[torch.from_numpy(np.array(a)) for a in
                           (stats.beta, stats.zp, stats.shift, stats.w)],
                         block=128)
    xp = tf.pad_rows(torch.from_numpy(x), 128)
    yp = tf.pad_rows(torch.from_numpy(y), 128)
    rf, rparts, rz = ref_tf.tsne_step_xla(
        jnp.asarray(xp.numpy()), jnp.asarray(yp.numpy()),
        jnp.asarray(spad.numpy()), 12.0, n_valid=300)
    f, parts, z = tf.tsne_step(xp, yp, spad, 12.0, n_valid=300)
    assert spad.shape == (384, 4) and (spad[300:, 2] == 1).all() \
        and (spad[300:, 3] == 0).all()
    assert abs(z.item() - float(rz)) <= 1e-5 * float(rz)
    rf = np.asarray(rf)
    assert np.abs(f.numpy() - rf).max() <= 1e-4 * np.abs(rf).max()
    assert (f[300:] == 0).all()
    np.testing.assert_allclose(parts.numpy(), np.asarray(rparts)[0],
                               rtol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 8, 32])
def test_locality_order_is_a_deterministic_permutation(d):
    """Every row once, the same order twice, ties (duplicate rows, a
    constant column) in row order; on clustered 8-D rows the order keeps
    each blob together."""
    rng = np.random.default_rng(d)
    cent = rng.uniform(-3, 3, size=(10, d))
    lab = rng.integers(0, 10, 600)
    x = (cent[lab] + 0.1 * rng.normal(size=(600, d))).astype(np.float32)
    x[50:60] = x[40]
    x[:, 0] = x[:, 0] if d == 1 else 2.0
    order = tf.locality_order(torch.from_numpy(x))
    assert order.dtype == torch.int64
    assert torch.equal(torch.sort(order).values, torch.arange(600))
    assert torch.equal(order, tf.locality_order(torch.from_numpy(x)))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(600)
    dup = pos[[40, *range(50, 60)]]
    assert bool((dup[1:] > dup[:-1]).all())
    if d == 8:
        changes = (lab[order.numpy()][1:] != lab[order.numpy()][:-1]).sum()
        assert changes < 30


@pytest.mark.parametrize("exag", [1.0, 12.0])
def test_fused_step_in_locality_order_matches_reference(exag):
    """tsne_step_fused permutes the rows into the locality order and the
    forces back: against the reference's fused step (its Pallas kernels
    in interpret mode) at N = 252, block 64, so four padding rows share
    the last tile with valid ones; the order passed in gives the same
    bits as the order computed."""
    x, y, w = _fixture(n=252, seed=7)
    order = tf.locality_order(torch.from_numpy(x))
    assert not torch.equal(order, torch.arange(252))
    stats = ref_tsne.calibrate_stats(jnp.asarray(x), 20.0,
                                     weights=jnp.asarray(w))
    rg, rkl = ref_ops.tsne_step_fused(
        jnp.asarray(x), jnp.asarray(y), stats.beta, stats.zp,
        shift=stats.shift, weights=stats.w, exaggeration=exag, block=64,
        interpret=True, return_kl=True)
    st = _stats(stats)
    g, kl = tf.tsne_step_fused(
        torch.from_numpy(x), torch.from_numpy(y), st.beta, st.zp,
        shift=st.shift, weights=st.w, exaggeration=exag, block=64,
        return_kl=True)
    rg = np.asarray(rg)
    assert g.shape == rg.shape == (252, 2)
    assert np.abs(g.numpy() - rg).max() <= 1e-4 * np.abs(rg).max()
    assert abs(kl.item() - float(rkl)) <= 1e-5 * abs(float(rkl))
    # the exact path computes the order once a run and passes it
    g2, kl2 = tf.tsne_step_fused(
        torch.from_numpy(x), torch.from_numpy(y), st.beta, st.zp,
        shift=st.shift, weights=st.w, exaggeration=exag, block=64,
        return_kl=True, order=order)
    assert torch.equal(g, g2) and torch.equal(kl, kl2)


def test_fused_twins_dispatch_by_device_and_cuda_wrappers_raise():
    x, y, _ = _fixture(n=64, seed=5)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    stats = tf.step_stats(torch.ones(64), torch.ones(64), None, None, 64)
    before = (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"])
    z = tf.tsne_z(yt)
    assert torch.equal(z, tf.tsne_z_torch(yt))
    f, parts = tf.tsne_forces(xt, yt, stats, z, 1.0)
    f2, parts2 = tf.tsne_forces_torch(xt, yt, stats, z, 1.0)
    assert torch.equal(f, f2) and torch.equal(parts, parts2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.tsne_z_cuda(yt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.tsne_forces_cuda(xt, yt, stats, z, 1.0)
    assert (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"]) == before


@pytest.mark.parametrize("backend", ["dense", "tiled", "pallas"])
def test_pipeline_run_tsne_exact_matches_reference(backend):
    par.assert_tsne_pipelines_agree(backend)


def test_run_tsne_exact_backends_fail_loud():
    x = torch.from_numpy(_fixture(n=64)[0])
    stats = tsne.calibrate_stats(x, 10.0)
    with pytest.raises(ValueError, match="sparse"):
        tsne.embedding_grad(x, torch.zeros((64, 2)), stats,
                            backend="sparse")
    with pytest.raises(ValueError, match="unknown backend"):
        tsne.run_tsne(x, tsne.TsneConfig(backend="fast"))
    with pytest.raises(ValueError, match="unknown cic"):
        tsne.run_tsne(x, tsne.TsneConfig(cic="cuda"))
    with pytest.raises(ValueError, match="init must have shape"):
        tsne.run_tsne(x, tsne.TsneConfig(), init=torch.zeros((3, 2)))
    # a mesh (P12b, once unported) needs a process group first
    with pytest.raises(ValueError, match="torch.distributed initialized"):
        tsne.run_tsne(x, tsne.TsneConfig(backend="tiled"), mesh=2)
    assert "kernel_mode" not in {
        f.name for f in dataclasses.fields(tsne.TsneConfig)}
    assert [f.name for f in dataclasses.fields(tsne.TsneConfig)] == [
        f.name for f in dataclasses.fields(ref_tsne.TsneConfig)
        if f.name != "kernel_mode"]
