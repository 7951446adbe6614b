"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the reference, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bit-exact on integer payloads; otherwise, against the plain
version run in float64, within 1e-5 of each row's own magnitude Σ|v|_row
plus 1e-6, as chip_smoke.py holds the kernel."""
import numpy as np
import pytest
import torch

from repro_torch.core import coo
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import segment_reduce as segred

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
