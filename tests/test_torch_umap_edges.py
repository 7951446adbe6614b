"""UMAP's per-edge epoch forces (K9, ``kernels/umap_edges.py``) on the CPU:
the plain twin against the op-by-op chain it stands for, the layouts'
``dst_pos`` against their ``dst_order``, the CPU path's refusal to launch
the kernel, and the epoch loop's buffers as a capture keeps them.  The
kernel itself runs in tests/test_torch_cuda_kernels.py, on the card."""
import numpy as np
import pytest
import torch

from repro_torch.core import coo, neighbors, umap
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import umap_edges


def _graph(n, k, dims, seed, neg_rate=5):
    """A src-sorted kNN-like edge list over ``n`` points with rows that
    have no edges, coincident points (d² = 0 on some edges and some
    negatives) and negatives that hit their edge's own src or dst."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(n, size=n - n // 5, replace=False))
    src = np.repeat(rows, k)
    dst = rng.integers(0, n, size=src.shape[0])
    y = rng.uniform(-5, 5, size=(n, dims)).astype(np.float32)
    y[1::7] = y[0]                                   # coincident points
    dst[::11] = np.where(src[::11] == 0, 1, 0)       # edges onto y[0]
    neg = rng.integers(0, n, size=(src.shape[0], neg_rate))
    neg[::3, 0] = src[::3]                           # hits the edge's src
    neg[1::4, 2] = dst[1::4]                         # hits its dst
    memb = rng.uniform(0.01, 1.0, size=src.shape[0]).astype(np.float32)
    lay, order = coo.edge_layout(torch.from_numpy(src),
                                 torch.from_numpy(dst), n)
    return (torch.from_numpy(y), lay, torch.from_numpy(memb)[order],
            torch.from_numpy(neg)[order])


@pytest.mark.parametrize("dims", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_twin_equals_edge_forces_then_gather(dims, seed):
    """The twin's src side is the chain's, and its attraction, put in
    place by ``dst_pos``, is the chain's gathered by ``dst_order``: bit
    for bit."""
    y, lay, memb, neg = _graph(300, 15, dims, seed)
    a, b = umap.fit_ab(1.0, 0.1)
    att, src_side = umap_edges.edge_forces(y, lay.src, lay.dst, memb, neg,
                                           a, b)
    got_src, got_att = umap_edges.umap_edge_forces_torch(
        y, lay.src, lay.dst, memb, neg, lay.dst_pos, a, b)
    assert torch.equal(got_src, src_side)
    assert torch.equal(got_att, att[lay.dst_order])
    same = (y[lay.src] == y[lay.dst]).all(1)
    assert bool(same.any()) and bool((att[same] == 0).all())
    hits = (neg == lay.src[:, None]) | (neg == lay.dst[:, None])
    assert bool(hits.any())
    assert bool(torch.isfinite(got_src).all())


@pytest.mark.parametrize("dims", [2, 4])
def test_cpu_epoch_delta_is_the_gather_chain(dims):
    """The CPU path's delta equals the chain with the attraction gathered
    by ``dst_order`` (the epoch before K9), bit for bit, and launches
    nothing."""
    y, lay, memb, neg = _graph(257, 15, dims, 5)
    a, b = umap.fit_ab(1.0, 0.1)
    before = dict(LAUNCHES)
    got = umap.epoch_delta(y, lay, memb, neg, a, b)
    assert dict(LAUNCHES) == before
    att, src_side = umap_edges.edge_forces(y, lay.src, lay.dst, memb, neg,
                                           a, b)
    want = coo.segment_reduce(src_side, lay.src_bounds) \
        - coo.segment_reduce(att[lay.dst_order].contiguous(),
                             lay.dst_bounds)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,n,e", [(0, 1, 1), (1, 50, 0), (2, 40, 333),
                                      (3, 1000, 15000), (4, 7, 200)])
def test_edge_layout_dst_pos_inverts_dst_order(seed, n, e):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, n, e))
    dst = torch.from_numpy(rng.integers(0, n, e))
    lay, _ = coo.edge_layout(src, dst, n)
    assert lay.dst_pos.dtype == torch.int64 and lay.dst_pos.shape == (e,)
    assert torch.equal(lay.dst_pos[lay.dst_order], torch.arange(e))
    assert torch.equal(lay.dst_order[lay.dst_pos], torch.arange(e))


@pytest.mark.parametrize("seed,n,e,s", [(0, 2, 1, 1), (1, 17, 60, 4),
                                        (2, 80, 400, 9), (3, 5, 40, 8),
                                        (4, 33, 1, 3), (5, 64, 250, 4)])
def test_edge_block_dst_pos_inverts_dst_order(seed, n, e, s):
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n, e))
    dst = rng.integers(0, n, e)
    slay = coo.shard_edge_layout(src, dst, n, s)
    for r in range(s):
        blk = slay.block(r, "cpu")
        ep = blk.dst_order.shape[0]
        assert blk.dst_pos.dtype == torch.int64
        assert torch.equal(blk.dst_pos[blk.dst_order], torch.arange(ep))
        assert torch.equal(blk.dst_order[blk.dst_pos], torch.arange(ep))


def test_forcing_the_kernel_on_cpu_raises_and_nothing_falls_back():
    y, lay, memb, neg = _graph(40, 3, 2, 2)
    before = LAUNCHES["umap_edge_forces"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        umap_edges.umap_edge_forces_cuda(y, lay.src, lay.dst, memb, neg,
                                         lay.dst_pos, 1.6, 0.9)
    assert LAUNCHES["umap_edge_forces"] == before


def test_epoch_buffers_outlive_the_loop(monkeypatch):
    """A wrapper on ``umap.epoch_delta`` that keeps references only, as
    the benchmark's check does: after the whole loop, the first epoch's
    kept inputs still give its kept delta, every epoch's kept ``y`` is
    the last one's plus alpha times its delta, and the last epoch's gives
    the result.  Nothing the capture holds was written in place."""
    kept = []
    orig = umap.epoch_delta

    def wrapper(*args):
        out = orig(*args)
        kept.append((args, out))
        return out
    monkeypatch.setattr(umap, "epoch_delta", wrapper)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(120, 3)).astype(np.float32))
    cfg = umap.UmapConfig(n_neighbors=6, n_epochs=12)
    idx, dist = neighbors.knn_graph(x, cfg.n_neighbors)
    edges, memb = umap.fuzzy_simplicial_set(idx, dist)
    y = umap.optimize_embedding(edges, memb, x.shape[0], cfg,
                                generator=torch.Generator().manual_seed(1))
    assert len(kept) == cfg.n_epochs
    (y0, lay, memb_n, neg0, a, b), out0 = kept[0]
    assert torch.equal(orig(y0, lay, memb_n, neg0, a, b), out0)
    for i in range(1, cfg.n_epochs):
        (y_prev, *_), out_prev = kept[i - 1]
        assert torch.equal(kept[i][0][0],
                           y_prev + umap._alpha(cfg, i - 1) * out_prev), i
    (y_last, *_), out_last = kept[-1]
    assert torch.equal(y, y_last + umap._alpha(cfg, cfg.n_epochs - 1)
                       * out_last)
