"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the reference, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances, as chip_smoke.py holds the kernels:

* K1 segment_reduce: bit-exact on integer payloads; otherwise, against
  the plain version run in float64, within 1e-5 of each row's own
  magnitude Σ|v|_row plus 1e-6.
* K2 cic_splat: float atomics add in a schedule-dependent order, so per
  cell within 1e-5·Σ|contributions to the cell| + 1e-6 of the float64
  plain version.
* K3 cic_gather: bit-exact against the float32 plain version (same
  roundings in the same order), and deterministic.
* K5a tsne_z / K5b tsne_forces: against the float64 plain version, Z and
  the KL rtol 1e-5, forces within 1e-4 of the largest force (the
  reference's own bar, tests/test_embed_backends.py); fp64 partials
  summed in a fixed order, so identical from call to call."""
import numpy as np
import pytest
import torch

from repro_torch.core import coo, tsne
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import cic
from repro_torch.kernels import segment_reduce as segred
from repro_torch.kernels import tsne_forces as tf

CASES = [(1, 16, 2), (16, 0, 2), (64, 3, 2), (33, 9, 3), (40, 5, 0),
         (0, 3, 2), (200, 40, 1), (3000, 15, 2)]


def _case(rows, fan, d, seed, integer):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 2 * fan + 1, size=rows) if fan else \
        np.zeros(rows, np.int64)
    if rows > 100:
        sizes[7] = 5000                       # a hub row
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    e = int(bounds[-1])
    shape = (e,) if d == 0 else (e, d)
    vals = (rng.integers(-1000, 1000, size=shape) if integer
            else rng.normal(size=shape)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(bounds)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,fan,d", CASES)
@pytest.mark.parametrize("integer", [True, False])
def test_segment_reduce_kernel_matches_plain(card, rows, fan, d, integer):
    v, b = _case(rows, fan, d, rows + fan + d, integer)
    before = LAUNCHES["segment_reduce"]
    got = coo.segment_reduce(v.to(card), b.to(card)).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES["segment_reduce"] == before + (rows > 0)
    want = segred.segment_reduce_torch(v.double(), b)
    assert got.shape == want.shape
    if integer:
        assert torch.equal(got, want.float())
    else:
        scale = segred.segment_reduce_torch(v.abs().double(), b)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()


@pytest.mark.cuda
def test_segment_reduce_wrapper_rejects_bad_inputs(card):
    b = torch.tensor([0, 2], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        segred.segment_reduce_cuda(torch.ones(2, device=card).double(), b)
    with pytest.raises(ValueError, match="int32"):
        segred.segment_reduce_cuda(torch.ones(2, device=card), b.long())
    with pytest.raises(ValueError, match="contiguous"):
        segred.segment_reduce_cuda(torch.ones(2, 2, device=card).T, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segred.segment_reduce_cuda(torch.ones(2), b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        coo.segment_reduce(torch.ones(2, device=card), b.cpu())


def _cic_case(n, g, c, seed):
    """Cells from tsne._cic_weights on a random embedding (its extreme
    points sit on the grid's edge cells), plus points pinned to the four
    corner cells with f = 0 and f = 1."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy((rng.normal(size=(n, 2)) * 5).astype(np.float32))
    i0, f, _ = tsne._cic_weights(y, g)
    edge = torch.tensor([[0, 0], [0, g - 2], [g - 2, 0], [g - 2, g - 2]],
                        dtype=torch.int32)
    k = min(n, 8)
    i0[:k] = edge[torch.arange(k) % 4]
    f[:k] = torch.tensor([[0.0, 0.0], [1.0, 1.0]])[torch.arange(k) % 2]
    vals = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    return i0.contiguous(), f.contiguous(), vals


CIC_CASES = [(1, 128, 3), (257, 128, 3), (5001, 128, 3), (3001, 1024, 3),
             (1000, 4, 1), (777, 64, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,c", CIC_CASES)
def test_cic_splat_kernel_matches_plain(card, n, g, c):
    i0, f, vals = _cic_case(n, g, c, n + g)
    before = LAUNCHES["cic_splat"]
    got = cic.cic_splat(i0.to(card), f.to(card), vals.to(card), g).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES["cic_splat"] == before + 1
    want = cic.cic_splat_torch(i0, f.double(), vals.double(), g)
    scale = cic.cic_splat_torch(i0, f.double(), vals.double().abs(), g)
    err = (got.double() - want).abs()
    assert got.shape == (c, g, g)
    assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,c", CIC_CASES)
def test_cic_gather_kernel_matches_plain_bit_for_bit(card, n, g, c):
    i0, f, _ = _cic_case(n, g, c, n + g + 1)
    fields = torch.from_numpy(np.random.default_rng(n).normal(
        size=(c + 1, g, g)).astype(np.float32))
    args = (fields.to(card), i0.to(card), f.to(card))
    before = LAUNCHES["cic_gather"]
    got = cic.cic_gather(*args)
    again = cic.cic_gather(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["cic_gather"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), cic.cic_gather_torch(fields, i0, f))
    assert torch.equal(got, cic.cic_gather_torch(*args))


def _tsne_case(n, dh, dims, seed, block=128):
    """Padded fused-step inputs: clustered x, spread y, calibrated stats
    with random weights; rows past n are padding (w = 0, zp = 1)."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-3, 3, size=(4, dh))
    x = (cent[rng.integers(0, 4, n)] + 0.3 * rng.normal(size=(n, dh)))
    x = torch.from_numpy(x.astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(n, dims)) * 3).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 100, n).astype(np.float32))
    st = tsne.calibrate_stats(x, min(30.0, max(n - 1, 1) / 3), weights=w)
    stats = tf.step_stats(st.beta, st.zp, st.shift, st.w, block)
    return tf.pad_rows(x, block), tf.pad_rows(y, block), stats


TSNE_CASES = [(5, 8, 2), (300, 8, 2), (1000, 8, 2), (1000, 3, 2),
              (517, 10, 3), (400, 32, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dh,dims", TSNE_CASES)
@pytest.mark.parametrize("exag", [1.0, 12.0])
def test_tsne_kernels_match_plain(card, n, dh, dims, exag):
    x, y, stats = _tsne_case(n, dh, dims, n + dh)
    xd, yd, sd = x.to(card), y.to(card), stats.to(card)
    before = (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"])
    f, parts, z = tf.tsne_step(xd, yd, sd, exag, n_valid=n)
    f2, parts2, z2 = tf.tsne_step(xd, yd, sd, exag, n_valid=n)
    torch.cuda.synchronize()
    assert (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"]) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(f, f2) and torch.equal(parts, parts2) \
        and torch.equal(z, z2)
    zw = tf.tsne_z_torch(y.double(), n)
    fw, pw = tf.tsne_forces_torch(x.double(), y.double(), stats.double(),
                                  zw, exag, n)
    assert f.shape == (x.shape[0], dims)
    assert abs(z.item() - zw.item()) <= 1e-5 * zw.item()
    scale = fw.abs().max().item()
    assert (f.cpu().double() - fw).abs().max().item() <= 1e-4 * scale
    kl = tf.step_kl(parts, z, exag).item()
    klw = tf.step_kl(pw, zw, exag).item()
    assert abs(kl - klw) <= 1e-5 * max(1.0, abs(klw))
    assert bool((f[n:] == 0).all())


@pytest.mark.cuda
def test_new_wrappers_reject_bad_inputs(card):
    i0 = torch.zeros((4, 2), dtype=torch.int32, device=card)
    f = torch.zeros((4, 2), device=card)
    vals = torch.ones((4, 3), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cic.cic_splat_cuda(i0.cpu(), f, vals, 8)
    with pytest.raises(ValueError, match="int32"):
        cic.cic_splat_cuda(i0.long(), f, vals, 8)
    with pytest.raises(ValueError, match="float32"):
        cic.cic_gather_cuda(torch.ones((3, 8, 8), device=card).double(),
                            i0, f)
    with pytest.raises(ValueError, match="contiguous"):
        cic.cic_splat_cuda(i0, f, torch.ones((3, 4), device=card).T, 8)
    y = torch.zeros((8, 2), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.tsne_z_cuda(y.cpu())
    with pytest.raises(ValueError, match="at most 32"):
        tf.tsne_forces_cuda(torch.zeros((8, 33), device=card), y,
                            torch.ones((8, 4), device=card),
                            torch.ones((), device=card), 1.0)
