"""The mesh tier on the card.  Every test needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the
reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

Ranks are processes (tests/_torch_mesh_ranks.py): gloo ranks sharing
cuda:0, and one nccl rank.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks_mod
from repro_torch.core import geo, hashing, prng, quantize, sketch
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
