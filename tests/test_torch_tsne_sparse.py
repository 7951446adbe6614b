"""The port's sparse tSNE backend against the JAX reference on the CPU:
the kNN-calibrated COO P, the FFT-grid repulsion (K2 splat → FFT → K3
gather, here the kernels' plain twins), one sparse gradient (attraction
through K1's twin), the optimizer update, the schedule and the adaptive
grid, then whole pipeline runs.  The CUDA kernels are held to the twins
in test_torch_cuda_kernels.py.

Tolerances:

* P from the same kNN graph: src/dst equal, values rtol 1e-5; from the
  same points: src/dst equal, values within 1e-6 of the total mass
  (Σ val = 1), since the kNN distances come from the fp32 Gram identity,
  whose products XLA and torch's BLAS sum in other orders;
* ``fft_repulsion``: rep within 1e-4 of its largest entry and z rtol
  1e-4, against both of the reference's splat/gather paths (its XLA
  loops and its interpret-mode Pallas kernels): the FFTs (pocketfft in
  XLA, torch's own on the CPU) sum in other orders, and the field is a
  difference of large convolved terms;
* ``sparse_grad``: forces within 1e-4 of the largest, KL rtol 1e-5;
* ``_momentum_update``: within 1e-6 of the largest coordinate (the
  recentering mean is summed in another order);
* the whole-run contract is in ``_torch_parity``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import neighbors as ref_neighbors
from repro.core import tsne as ref_tsne
from repro_torch.core import pipeline, tsne
from repro_torch.kernels import LAUNCHES


def _blobs(n=300, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(4, d))
    x = np.concatenate([c + 0.25 * rng.normal(size=(n // 4, d))
                        for c in centers]).astype(np.float32)
    return x, rng.uniform(1, 100, size=len(x)).astype(np.float32)


def _ref_sparse_p(x, w, k):
    idx, dist = ref_neighbors.knn_graph(jnp.asarray(x), k)
    return idx, dist, ref_tsne.sparse_p_from_knn(idx, dist, 20.0,
                                                 weights=jnp.asarray(w))


def _port_sparse_p(ref_sp):
    return tsne.SparseP(*[torch.from_numpy(np.array(a)).to(
        torch.int64 if i < 2 else None) for i, a in enumerate(ref_sp)])


@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_p_from_knn_matches_reference(weighted):
    x, w = _blobs(seed=1)
    idx, dist = ref_neighbors.knn_graph(jnp.asarray(x), 30)
    ref = ref_tsne.sparse_p_from_knn(
        idx, dist, 15.0, weights=jnp.asarray(w) if weighted else None)
    got = tsne.sparse_p_from_knn(
        torch.from_numpy(np.array(idx)).long(),
        torch.from_numpy(np.array(dist)), 15.0,
        weights=torch.from_numpy(w) if weighted else None)
    np.testing.assert_array_equal(np.asarray(ref.src), got.src.numpy())
    np.testing.assert_array_equal(np.asarray(ref.dst), got.dst.numpy())
    np.testing.assert_array_equal(np.asarray(ref.bounds), got.bounds.numpy())
    np.testing.assert_allclose(got.val.numpy(), np.asarray(ref.val),
                               rtol=1e-5, atol=1e-12)
    assert abs(got.val.sum().item() - 1.0) <= 1e-5


def test_build_sparse_p_end_to_end_and_unported_knn():
    """Exact and approximate kNN builds (the latter, once unported,
    given the reference's draws) give the reference's P."""
    from repro.core import ann as ref_ann
    from repro_torch import carry
    x, w = _blobs(n=200, seed=2)
    for method in ("exact", "ann"):
        ref = ref_tsne.build_sparse_p(jnp.asarray(x), 10.0, k=25,
                                      weights=jnp.asarray(w), method=method)
        draws = None if method == "exact" else carry.ann_draws_from_numpy(
            *par.ann_draws(ref_ann.AnnConfig(), 200, 8, 25))
        got = tsne.build_sparse_p(torch.from_numpy(x), 10.0, k=25,
                                  weights=torch.from_numpy(w), method=method,
                                  ann_draws=draws)
        np.testing.assert_array_equal(np.asarray(ref.src), got.src.numpy())
        np.testing.assert_array_equal(np.asarray(ref.dst), got.dst.numpy())
        np.testing.assert_allclose(got.val.numpy(), np.asarray(ref.val),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("g", [16, 64])
def test_fft_repulsion_matches_reference(g):
    rng = np.random.default_rng(g)
    y = (rng.normal(size=(300, 2)) * 3).astype(np.float32)
    rep, z = tsne.fft_repulsion(torch.from_numpy(y), g)
    for cic in ("xla", "pallas"):
        rr, rz = ref_tsne.fft_repulsion(jnp.asarray(y), g, cic=cic,
                                        interpret=True)
        rr = np.asarray(rr)
        assert np.abs(rep.numpy() - rr).max() <= 1e-4 * np.abs(rr).max()
        assert abs(z.item() - float(rz)) <= 1e-4 * float(rz)


@pytest.mark.parametrize("exag", [1.0, 12.0])
def test_sparse_grad_matches_reference(exag):
    x, w = _blobs(seed=3)
    _, _, ref_sp = _ref_sparse_p(x, w, 30)
    y = (np.random.default_rng(4).normal(size=(len(x), 2)) * 2).astype(
        np.float32)
    rg, rkl = ref_tsne.sparse_grad(jnp.asarray(y), ref_sp, exag,
                                   grid_size=64)
    before = LAUNCHES.copy()
    g, kl = tsne.sparse_grad(torch.from_numpy(y), _port_sparse_p(ref_sp),
                             exag, grid_size=64)
    assert LAUNCHES == before               # CPU tensors: twins only
    rg = np.asarray(rg)
    assert np.abs(g.numpy() - rg).max() <= 1e-4 * np.abs(rg).max()
    assert abs(kl.item() - float(rkl)) <= 1e-5 * abs(float(rkl))


def test_momentum_update_and_phase_match_reference():
    rng = np.random.default_rng(5)
    y, vel, grad = (rng.normal(size=(100, 2)).astype(np.float32)
                    for _ in range(3))
    vel[::3] = 0.0
    grad[::7] = 0.0
    gains = rng.uniform(0.01, 3, size=(100, 2)).astype(np.float32)
    for it in (0, 124, 125, 400):
        ref_cfg, cfg = ref_tsne.TsneConfig(), tsne.TsneConfig()
        exag, mom = ref_tsne._phase(jnp.asarray(it), ref_cfg)
        assert (float(exag), float(mom)) == tuple(
            np.float32(v) for v in tsne._phase(it, cfg))
        ref = ref_tsne._momentum_update(
            ref_tsne.TsneState(*map(jnp.asarray, (y, vel, gains))),
            jnp.asarray(grad), mom, ref_cfg)
        got = tsne._momentum_update(
            tsne.TsneState(*map(torch.from_numpy, (y, vel, gains))),
            torch.from_numpy(grad), tsne._phase(it, cfg)[1], cfg)
        for r, t in zip(ref, got):
            r = np.asarray(r)
            assert np.abs(t.numpy() - r).max() <= 1e-6 * np.abs(r).max()


def test_adaptive_grid_matches_reference():
    kw = dict(grid_size=32, grid_interval=0.5, grid_max=256)
    ref_cfg, cfg = ref_tsne.TsneConfig(**kw), tsne.TsneConfig(**kw)
    for span, g in ((1.0, 32), (20.0, 32), (50.0, 32), (1e6, 32),
                    (1.0, 128)):
        assert tsne._grid_for_span(span, g, cfg) == \
            ref_tsne._grid_for_span(span, g, ref_cfg)
    x, w = _blobs(n=200, seed=6)
    tc = dict(n_iter=20, perplexity=10.0, learning_rate=10.0, grid_size=16,
              grid_interval=0.002, grid_max=64, adaptive_interval=5)
    init = par.tsne_init(0, 200, 2)
    ref, _ = ref_tsne.run_tsne(jax.random.key(0), jnp.asarray(x),
                               ref_tsne.TsneConfig(**tc), backend="sparse",
                               weights=jnp.asarray(w),
                               init=jnp.asarray(init))
    got, kls = tsne.run_tsne(torch.from_numpy(x), tsne.TsneConfig(**tc),
                             backend="sparse", weights=torch.from_numpy(w),
                             init=torch.from_numpy(init))
    assert kls.shape == (20,) and bool(torch.isfinite(kls).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def test_run_tsne_fail_loud_and_zero_iterations():
    x = torch.from_numpy(_blobs(n=64)[0])
    with pytest.raises(ValueError, match="dims"):
        tsne.run_tsne(x, tsne.TsneConfig(dims=3, backend="sparse"))
    with pytest.raises(ValueError, match="unknown cic"):
        tsne.run_tsne(x, tsne.TsneConfig(backend="sparse", cic="cuda"))
    init = torch.randn((64, 2), dtype=torch.float64)
    for backend in ("sparse", "tiled"):
        y, kls = tsne.run_tsne(x, tsne.TsneConfig(n_iter=0), backend=backend,
                               init=init)
        assert torch.equal(y, init.to(torch.float32)) and kls.shape == (0,)
    gen = torch.Generator().manual_seed(3)
    y, _ = tsne.run_tsne(x, tsne.TsneConfig(n_iter=0), generator=gen)
    assert y.shape == (64, 2) and y.abs().max() < 1e-3


def test_pipeline_tsne_config_and_unported_paths():
    import dataclasses
    from repro.configs import sns_paper as ref_paper
    from repro.core import pipeline as ref_pipeline
    from repro_torch.configs import sns_paper
    cfg = sns_paper.CANCER_100K
    want = dataclasses.asdict(ref_pipeline.resolve_embed_cfg(
        ref_paper.CANCER_100K))
    assert want.pop("kernel_mode") == "auto"
    assert dataclasses.asdict(pipeline.resolve_embed_cfg(cfg)) == want
    # the embed mesh (P12b, once refused here) leaves the config alone
    assert pipeline.resolve_embed_cfg(dataclasses.replace(
        cfg, embed_mesh=2)) == pipeline.resolve_embed_cfg(cfg)


def test_pipeline_run_tsne_sparse_matches_reference():
    par.assert_tsne_pipelines_agree("sparse")
