"""Parity of the port's UMAP path (repro_torch.core.neighbors / umap) with
the JAX reference: kNN indices equal and distances within 1e-5; fuzzy-set
memberships within 1e-5; one epoch's delta within 1e-5 relative given
the same negative samples.  Distances come from the Gram identity in both
frameworks, whose fp32 products are summed in different orders, so the
distances differ in the last bits and everything downstream inherits
that."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import coo as ref_coo
from repro.core import neighbors as ref_neighbors
from repro.core import umap as ref_umap
from repro_torch.core import coo, neighbors, umap


def _blobs(n_per, dims, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, size=(3, dims))
    return np.concatenate([c + 0.3 * rng.normal(size=(n_per, dims))
                           for c in centers]).astype(np.float32)


@pytest.mark.parametrize("block", [None, 64])
def test_knn_graph_matches_reference(block):
    x = _blobs(70, 5, 0)
    ri, rd = ref_neighbors.knn_graph(jnp.asarray(x), 8, block=block)
    ti, td = neighbors.knn_graph(torch.from_numpy(x), 8, block=block)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    np.testing.assert_allclose(np.asarray(rd), td.numpy(), rtol=0, atol=1e-5)


def test_knn_graph_unported_paths_raise():
    """Unknown methods raise, and so do the exact and the approximate
    mesh builds without a process group (the approximate one, P12b, once
    raising as unported); "ann" (P9, once raising here too) returns the
    graph."""
    x = torch.zeros((10, 2))
    idx, dist = neighbors.knn_graph(x + torch.arange(10.)[:, None], 3,
                                    method="ann")
    assert idx.shape == dist.shape == (10, 3)
    assert torch.equal(idx, neighbors.knn_graph(
        x + torch.arange(10.)[:, None], 3)[0])
    with pytest.raises(ValueError, match="torch.distributed initialized"):
        neighbors.knn_graph(x, 3, method="ann", mesh=4)
    with pytest.raises(ValueError, match="torch.distributed initialized"):
        neighbors.knn_graph(x, 3, mesh=4)
    with pytest.raises(ValueError, match="unknown kNN method"):
        neighbors.knn_graph(x, 3, method="hnsw")
    assert neighbors.knn_graph(x + torch.arange(10.)[:, None], 3,
                               method="auto")[0].shape == (10, 3)


@pytest.mark.parametrize("n", [2 ** 16, 2 ** 16 + 1])
def test_reverse_edge_values_both_branches(n):
    """N = 2¹⁶ takes the packed-key sort branch, 2¹⁶ + 1 the gather
    branch; a ring graph keeps it cheap and every reverse value known."""
    i = np.arange(n, dtype=np.int64)
    knn_idx = np.stack([(i + 1) % n, (i - 1) % n], 1).astype(np.int32)
    vals_nk = (2.0 * i[:, None] + np.array([0.0, 1.0])).astype(np.float32)
    rows = np.repeat(i, 2).astype(np.int32)
    cols = knn_idx.reshape(-1)
    ref = np.asarray(ref_neighbors.reverse_edge_values(
        jnp.asarray(knn_idx), jnp.asarray(vals_nk), jnp.asarray(rows),
        jnp.asarray(cols), jnp.asarray(vals_nk.reshape(-1)), n))
    got = neighbors.reverse_edge_values(
        torch.from_numpy(knn_idx).long(), torch.from_numpy(vals_nk),
        torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
        torch.from_numpy(vals_nk.reshape(-1)), n)
    np.testing.assert_array_equal(ref, got.numpy())


def _graph(seed=1):
    x = _blobs(60, 4, seed)
    w = np.random.default_rng(seed).uniform(1, 20, len(x)).astype(np.float32)
    ri, rd = ref_neighbors.knn_graph(jnp.asarray(x), 6)
    return x, w, ri, rd


def test_fuzzy_simplicial_set_matches_reference():
    _, w, ri, rd = _graph()
    for weights in (None, w):
        re_, rm = ref_umap.fuzzy_simplicial_set(
            ri, rd, weights=None if weights is None else jnp.asarray(weights))
        te, tm = umap.fuzzy_simplicial_set(
            torch.from_numpy(np.array(ri)).long(), torch.from_numpy(
                np.array(rd)),
            weights=None if weights is None else torch.from_numpy(weights))
        np.testing.assert_array_equal(np.asarray(re_), te.numpy())
        np.testing.assert_allclose(np.asarray(rm), tm.numpy(), rtol=0,
                                   atol=1e-5)


def test_epoch_delta_matches_reference_given_negatives():
    _, w, ri, rd = _graph(2)
    edges, memb = ref_umap.fuzzy_simplicial_set(ri, rd,
                                                weights=jnp.asarray(w))
    n, e = ri.shape[0], edges.shape[0]
    a, b = ref_umap.fit_ab(1.0, 0.1)
    assert (a, b) == umap.fit_ab(1.0, 0.1)
    lay, order = ref_coo.edge_layout(edges[:, 0], edges[:, 1], n)
    memb_n = (memb / jnp.max(memb))[order]
    kneg = jax.random.key(9)
    neg = np.array(jax.random.randint(kneg, (e, 5), 0, n))
    y = np.random.default_rng(3).uniform(-5, 5, (n, 2)).astype(np.float32)
    ref = np.asarray(ref_umap.epoch_delta(jnp.asarray(y), lay, memb_n, kneg,
                                          a, b, 5))
    tlay, torder = coo.edge_layout(
        torch.from_numpy(np.array(edges[:, 0])).long(),
        torch.from_numpy(np.array(edges[:, 1])).long(), n)
    assert torch.equal(torder, torch.from_numpy(np.array(order)).long())
    got = umap.epoch_delta(torch.from_numpy(y), tlay,
                           torch.from_numpy(np.array(memb_n)),
                           torch.from_numpy(neg).long(), a, b).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_run_umap_matches_reference_given_draws():
    """Two epochs end to end; the last-bit distance differences grow
    through the memberships and each epoch (chaotically over a long run,
    which the blob test below covers as a quality contract instead)."""
    x, w, _, _ = _graph(3)
    cfg = ref_umap.UmapConfig(n_neighbors=6, n_epochs=2)
    tcfg = umap.UmapConfig(n_neighbors=6, n_epochs=2)
    key = jax.random.key(11)
    ref = np.asarray(ref_umap.run_umap(key, jnp.asarray(x), cfg,
                                       weights=jnp.asarray(w)))
    init, negs = par.umap_draws(key, len(x), len(x) * 6, 2, 2, 5)
    got = umap.run_umap(torch.from_numpy(x), tcfg,
                        weights=torch.from_numpy(w),
                        init=torch.from_numpy(init),
                        negatives=torch.from_numpy(negs).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="init must have shape"):
        umap.run_umap(torch.from_numpy(x), tcfg, init=torch.zeros(3, 2))


def test_run_umap_blobs_separate_with_own_draws():
    """The reference's quality contract (tests/test_umap.py) on the
    port's own generator draws."""
    rng = np.random.default_rng(2)
    centers = np.array([[0, 0, 0], [5, 5, 5], [-5, 5, 0]], np.float32)
    x = np.concatenate([c + 0.05 * rng.normal(size=(40, 3)) for c in centers]
                       ).astype(np.float32)
    labels = np.repeat(np.arange(3), 40)
    g = torch.Generator().manual_seed(0)
    y = umap.run_umap(torch.from_numpy(x),
                      umap.UmapConfig(n_neighbors=10, n_epochs=150),
                      generator=g).numpy()
    assert not np.isnan(y).any()
    intra, inter = [], []
    for a in range(3):
        ya = y[labels == a]
        intra.append(np.linalg.norm(ya - ya.mean(0), axis=1).mean())
        for b in range(a + 1, 3):
            inter.append(np.linalg.norm(ya.mean(0) - y[labels == b].mean(0)))
    assert min(inter) > 1.5 * max(intra)


def test_dense_symmetrization_matches_reference_and_sparse():
    """symmetrize="dense" (the (N, N) scatter-max path) against the
    reference's dense path and the port's own sparse form."""
    _, w, ri, rd = _graph(4)
    idx, dist = torch.from_numpy(np.array(ri)).long(), torch.from_numpy(
        np.array(rd))
    for weights in (None, w):
        rw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        re_, rm = ref_umap.fuzzy_simplicial_set(ri, rd, weights=rw,
                                                symmetrize="dense")
        te, tm = umap.fuzzy_simplicial_set(idx, dist, weights=tw,
                                           symmetrize="dense")
        se, sm = umap.fuzzy_simplicial_set(idx, dist, weights=tw)
        np.testing.assert_array_equal(np.asarray(re_), te.numpy())
        assert torch.equal(te, se)
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tm.numpy(), sm.numpy(), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unknown symmetrize"):
        umap.fuzzy_simplicial_set(idx, dist, symmetrize="lower")
