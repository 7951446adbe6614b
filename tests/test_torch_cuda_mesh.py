"""The mesh tier on the card.  Every test needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the
reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

Ranks are processes (tests/_torch_mesh_ranks.py): gloo ranks sharing
cuda:0, and one nccl rank.  The sketch tier must give the single-device
table bit for bit; the approximate kNN on a mesh the single-device graph
bit for bit, and the sharded tSNE gradient of its P the single-device
``sparse_grad`` within 1e-4·max|grad| (the grid's all-reduce sums float32
grids in another order), exactly 0 on padded rows, the KL within 1e-3.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks_mod
from repro_torch.core import ann, geo, hashing, neighbors, prng, quantize
from repro_torch.core import sketch, tsne
from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture

HH_FIELDS = ("key_hi", "key_lo", "count", "mask")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import _build
    _build.build_all()          # once, before any rank loads a kernel
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(card, tmp_path_factory):
    """2²⁰ mixture points, their grid, and the single-device fold and
    heavy hitters on the card at the default hash draw."""
    pts, _ = gaussian_mixture(1 << 20, MixtureSpec(dims=8), seed=1)
    grid = quantize.fit_grid(torch.from_numpy(pts), 25)
    sk, cands, _ = geo.sketch_shard(
        sketch.init(geo.shared_params(0, 16, card), 18), grid,
        torch.from_numpy(pts).to(card), 1024)
    hh = hh_mod.from_candidates(sk, cands, 512)
    inp = dict(pts=pts, bins=np.int64(25),
               lo=np.asarray(grid.lo, np.float32),
               hi=np.asarray(grid.hi, np.float32))
    return inp, sk.table.cpu().numpy(), hh, tmp_path_factory.mktemp("ranks")


def _ranks(case, world, shared):
    inp, _, _, tmp = case
    out = tmp / f"{world}-{'gloo' if shared else 'nccl'}"
    out.mkdir()
    np.savez(out / "in.npz", shared=np.bool_(shared), **inp)
    return ranks_mod.spawn("card", world, out / "in.npz", out)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_card_hash_draw_equals_the_cpu_draw(card, seed):
    """The default draw is the reference's threefry bits on any device."""
    a = geo.shared_params(seed, 16, card)
    b = hashing.make_params(prng.key(seed), 16)
    for x, y in zip(a, b):
        assert x.is_cuda and torch.equal(x.cpu(), y)


@pytest.mark.cuda
def test_gloo_ranks_sharing_the_card_fold_like_one_device(case):
    """Two gloo ranks on cuda:0: each merged table equals the
    single-device fold bit for bit, K7 and K8 ran once a rank, both ranks
    hold the same heavy hitters and count every point."""
    _, table, _, _ = case
    outs = _ranks(case, 2, shared=True)
    for o in outs:
        np.testing.assert_array_equal(o["table"], table)
        assert float(o["total"]) == float(1 << 20)
        assert (int(o["k7"]), int(o["k8"])) == (1, 1)
        for f in HH_FIELDS:
            np.testing.assert_array_equal(o[f"hh_{f}"], outs[0][f"hh_{f}"])


@pytest.mark.cuda
def test_one_nccl_rank_gives_the_same_bits(case):
    """One nccl rank: the merged table and the heavy hitters equal the
    single-device fold's and extraction's bit for bit."""
    _, table, hh, _ = case
    (o,) = _ranks(case, 1, shared=False)
    np.testing.assert_array_equal(o["table"], table)
    assert (int(o["k7"]), int(o["k8"])) == (1, 1)
    for f in HH_FIELDS:
        np.testing.assert_array_equal(o[f"hh_{f}"],
                                      getattr(hh, f).cpu().numpy())


TSNE_CASE = dict(n=20_003, k=30, perplexity=10.0, grid=64)


@pytest.fixture(scope="module")
def tsne_case(card, tmp_path_factory):
    """Ten weighted blobs of 20 003 points in 8 dims on the card, their
    single-device ANN graph and the single-device sparse gradient of its
    P at a spread-out y."""
    rng = np.random.default_rng(0)
    n = TSNE_CASE["n"]
    centers = rng.uniform(-20, 20, size=(10, 8))
    x = (centers[rng.integers(0, 10, n)]
         + rng.normal(size=(n, 8))).astype(np.float32)
    w = rng.integers(1, 50, n).astype(np.float32)
    y = (2.0 * rng.normal(size=(n, 2))).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(card), torch.from_numpy(w).to(card)
    idx, dist = neighbors.knn_graph(xt, TSNE_CASE["k"], method="ann")
    sp = tsne.sparse_p_from_knn(idx, dist, TSNE_CASE["perplexity"],
                                weights=wt)
    g, kl = tsne.sparse_grad(torch.from_numpy(y).to(card), sp, 12.0,
                             grid_size=TSNE_CASE["grid"])
    inp = dict(x=x, w=w, y=y, k=np.int64(TSNE_CASE["k"]),
               perplexity=np.float64(TSNE_CASE["perplexity"]),
               grid=np.int64(TSNE_CASE["grid"]))
    want = dict(idx=idx.cpu().numpy(), dist=dist.cpu().numpy(),
                grad=g.cpu().numpy(), kl=kl.item())
    return inp, want, tmp_path_factory.mktemp("tsne_ranks")


def _tsne_ranks(case, world, shared):
    inp, want, tmp = case
    out = tmp / f"{world}-{'gloo' if shared else 'nccl'}"
    out.mkdir()
    np.savez(out / "in.npz", shared=np.bool_(shared), **inp)
    outs = ranks_mod.spawn("card_tsne", world, out / "in.npz", out)
    n = inp["x"].shape[0]
    cfg = ann.AnnConfig()
    tiles = -(-n // ann._bucket_size(cfg, int(inp["k"])))
    per_rank = -(-tiles // world)
    k4 = cfg.probes * -(-per_rank // ann._TILE_CHUNK)
    # relative to the largest entry: the entries are far below 1 here
    scale = float(np.abs(want["grad"]).max())
    for o in outs:
        np.testing.assert_array_equal(o["idx"], want["idx"])
        np.testing.assert_array_equal(o["dist"], want["dist"])
        assert float(np.abs(o["grad"][:n] - want["grad"]).max()) <= \
            1e-4 * scale
        assert float(np.abs(o["grad"][n:]).max(initial=0.0)) == 0.0
        assert abs(float(o["kl"]) - want["kl"]) <= 1e-3
        assert int(o["k4"]) == k4
        for op in ("segment_reduce", "cic_splat", "cic_gather"):
            assert int(o[op]) == 1, op


@pytest.mark.cuda
def test_gloo_ranks_sharing_the_card_run_the_ann_and_the_gradient(
        tsne_case):
    """Two gloo ranks on cuda:0: the mesh ANN graph equals the
    single-device one bit for bit, K4 ran on each rank's half of the
    tiles, and the sharded gradient (K1, K2, K3 once a rank) is within
    1e-4·max|grad| of ``sparse_grad``."""
    _tsne_ranks(tsne_case, 2, shared=True)


@pytest.mark.cuda
def test_one_nccl_rank_runs_the_ann_and_the_gradient(tsne_case):
    """One nccl rank: the same graph bits and gradient bar."""
    _tsne_ranks(tsne_case, 1, shared=False)
