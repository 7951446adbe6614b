"""The plain reference against the program's stages at tiny sizes on the
CPU (the program's CPU paths are its kernels' plain twins)."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from snsbench import datagen
from snsbench.reference import sns_reference as R

F32 = torch.float32
DATA = {"points": 60_000, "dims": 8, "clusters": 10, "cluster_std": 0.02,
        "background_frac": 0.3, "box": [0.0, 1.0]}


@pytest.fixture(scope="module")
def pts():
    return datagen.mixture(DATA, 7, 0, "cpu")


def test_the_reference_imports_nothing_of_the_program():
    src = Path(R.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "numpy", "torch",
                     "scipy"}


def test_hashes_equal_the_programs():
    from repro_torch.core import hashing
    p = datagen.hash_params(3, 16, "cpu")
    keys = torch.randint(0, 1 << 48, (5000,), dtype=torch.int64)
    b, s = hashing.hashes(hashing.MulShiftParams(*p), keys >> 32,
                          keys & R.M32, 18)
    for r in range(16):
        rb, rs = R.hash_row(p, r, keys, 18)
        assert torch.equal(rb, b[r]) and torch.equal(rs, s[r])


@pytest.mark.parametrize("bins,top_k", [(25, 300), (48, 2000)])
def test_heavy_hitters_and_reps_equal_the_programs(pts, bins, top_k):
    from repro_torch.core import hashing, pipeline, umap
    from repro_torch.configs.sns_paper import CANCER
    cfg = dataclasses.replace(CANCER, bins=bins, top_k=top_k)
    p = datagen.hash_params(5, cfg.rows, "cpu")
    jit = datagen.jitter(5, top_k, cfg.max_replicas, 8, 0.25, "cpu")
    res = pipeline.run(cfg, pts, device="cpu",
                       umap_cfg=umap.UmapConfig(n_epochs=1),
                       draws=pipeline.Draws(
                           hash_params=hashing.MulShiftParams(*p),
                           jitter=jit))
    grid, hh = R.heavy_hitters(pts, bins, p, cfg.log2_cols, top_k, F32)
    assert torch.equal((res.hh.key_hi << 32) | res.hh.key_lo, hh.keys)
    assert torch.equal(res.hh.count, hh.count)
    assert torch.equal(res.hh.mask, hh.mask)
    reps = R.representatives(grid, hh, jit, cfg.max_replicas, F32)
    assert torch.equal(res.reps.mask, reps.mask)
    assert torch.equal(res.reps.points, reps.points)
    assert torch.equal(res.reps.weight, reps.weight)


@pytest.fixture(scope="module")
def cloud():
    g = torch.Generator().manual_seed(11)
    x = torch.rand((3000, 8), generator=g)
    w = torch.rand((3000,), generator=g) + 0.5
    return x, w


def test_knn_rows_are_the_exact_neighbours(cloud):
    from repro_torch.core import neighbors
    x, _ = cloud
    idx, dist = neighbors.knn_graph(x, 15, method="exact")
    rows = torch.arange(0, 3000, 7)
    ridx, rdist = R.knn_rows(x, rows, 15, F32)
    assert (ridx == idx[rows]).float().mean() > 0.999
    torch.testing.assert_close(rdist, dist[rows], rtol=1e-4, atol=1e-5)


def test_fuzzy_set_and_epoch_equal_the_programs(cloud):
    from repro_torch.core import coo, neighbors, umap
    x, w = cloud
    idx, dist = neighbors.knn_graph(x, 15, method="exact")
    _, memb = umap.fuzzy_simplicial_set(idx, dist, weights=w)
    ref = R.fuzzy_set(idx, dist, w, 50, F32)
    torch.testing.assert_close(ref, memb, rtol=0, atol=1e-6)
    edges = torch.stack([torch.arange(3000).repeat_interleave(15),
                         idx.reshape(-1)], 1)
    lay, order = coo.edge_layout(edges[:, 0], edges[:, 1], 3000)
    memb_n = (memb / memb.max())[order]
    a, b = R.umap_ab(1.0, 0.1)
    assert (a, b) == umap.fit_ab(1.0, 0.1)
    y = torch.rand((3000, 2)) * 10
    neg = torch.randint(0, 3000, (lay.src.shape[0], 5))
    got = umap.epoch_delta(y, lay, memb_n, neg, a, b)
    want = R.umap_epoch(y, lay.src, lay.dst, memb_n, neg, a, b, F32)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_sparse_p_gradient_and_update_equal_the_programs(cloud):
    from repro_torch.core import neighbors, tsne
    x, w = cloud
    idx, dist = neighbors.knn_graph(x, 90, method="exact")
    sp = tsne.sparse_p_from_knn(idx, dist, 30.0, weights=w)
    p = R.sparse_p(idx, dist, w, 30.0, 50, F32)
    assert torch.equal(p.src, sp.src) and torch.equal(p.dst, sp.dst)
    torch.testing.assert_close(p.val, sp.val, rtol=1e-5, atol=1e-9)
    y = torch.randn((3000, 2)) * 5
    for exag, g in ((12.0, 256), (1.0, 512)):
        got, _ = tsne.sparse_grad(y, sp, exag, grid_size=g)
        want = R.tsne_grad(y, p, exag, g, F32)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    cfg = tsne.TsneConfig(learning_rate=250.0)
    st = tsne.TsneState(y, torch.randn_like(y), torch.rand_like(y) + 0.5)
    grad = torch.randn_like(y)
    out = tsne._momentum_update(st, grad, 0.8, cfg)
    want = R.tsne_update(st.y, st.velocity, st.gains, grad, 0.8, 250.0, 0.01,
                         F32)
    assert float((out.y - want).abs().max() / want.abs().max()) < 1e-6


def test_the_control_differs_from_the_reference(pts):
    p = datagen.hash_params(5, 16, "cpu")
    _, hh = R.heavy_hitters(pts, 25, p, 18, 300, F32)
    _, hb = R.heavy_hitters(pts, 25, p, 18, 300, torch.bfloat16)
    assert int((hh.keys != hb.keys).sum()) > 30
