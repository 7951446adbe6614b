"""The port's approximate kNN engine (repro_torch.core.ann) and its
distance-tile kernel's plain twin (K4, kernels/knn_tile.py) against the
JAX reference on the CPU.  The CUDA kernel is held to the twin in
test_torch_cuda_kernels.py.

Tolerances:

* distance tiles: the same +inf pattern; finite values within 1e-5 of
  |q|² + |c|², the Gram form's own scale (both sides round
  |q|² + |c|² − 2·q·c in fp32, summing the products in other orders);
* cell keys, probe layouts, the dedupe merge and the reverse sample:
  bit-identical given the same rotated coordinates, rotation or offsets;
* one NN-descent round given the same slot draws: indices identical,
  squared distances rtol 1e-6 (direct sums of D squares, summed in other
  orders);
* whole builds given the reference's draws: mean per-row neighbour-set
  overlap ≥ 0.99, and the distances of the entries both list within
  1e-5 (stage 1's Gram-form tiles, as above); with the port's own
  draws: recall ≥ 0.9 against the exact graph (the reference's own
  contract, tests/test_ann.py).

The reference runs its XLA distance tiles (``tile="xla"``), apart from
one case against its interpret-mode Pallas kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import ann as ref_ann
from repro.core import neighbors as ref_neighbors
from repro.kernels import knn_tile as ref_tile
from repro_torch import carry
from repro_torch.core import ann, neighbors
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import knn_tile


def _points(n, dims, seed, clusters=8):
    """Blobs, as heavy-hitter representatives look (tests/test_ann.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (clusters, dims))
    x = centers[rng.integers(0, clusters, n)] + rng.normal(0, 0.3, (n, dims))
    return x.astype(np.float32)


def _overlap(a, b):
    """Mean per-row share of a's neighbours that b also lists."""
    a, b = np.asarray(a), np.asarray(b)
    k = a.shape[1]
    return float(np.mean([len(set(r) & set(s)) / k for r, s in zip(a, b)]))


def _tiles(t, b, c, d, seed):
    """Random tiles with padded query rows, padded candidates, self pairs
    and a partial last tile (its tail rows and candidates are padding)."""
    rng = np.random.default_rng(seed)
    qx = rng.normal(size=(t, b, d)).astype(np.float32)
    cx = rng.normal(size=(t, c, d)).astype(np.float32)
    qid = rng.integers(0, 4 * b, (t, b)).astype(np.int32)
    cid = rng.integers(0, 4 * b, (t, c)).astype(np.int32)
    qid[-1, b // 2:] = -1
    cid[-1, c // 2:] = -1
    cid[:, :3] = -1
    cid[0, 5] = qid[0, 2]
    cid[t // 2, c - 1] = qid[t // 2, 0]
    return qx, qid, cx, cid


@pytest.mark.parametrize("path", ["xla", "pallas"])
@pytest.mark.parametrize("t,b,d", [(3, 8, 5), (16, 16, 8)])
def test_distance_tiles_twin_matches_reference(path, t, b, d):
    qx, qid, cx, cid = _tiles(t, b, 3 * b, d, t + d)
    args = [jnp.asarray(a) for a in (qx, qid, cx, cid)]
    if path == "xla":
        want = np.asarray(ref_tile._distance_tiles_xla(*args))
    else:
        want = np.asarray(ref_tile._distance_tiles_pallas(*args,
                                                          interpret=True))
    before = dict(LAUNCHES)
    got = knn_tile.distance_tiles(*[torch.from_numpy(a)
                                    for a in (qx, qid, cx, cid)]).numpy()
    assert dict(LAUNCHES) == before           # a CPU tensor takes the twin
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[0, 2, 5]) and np.isinf(got[:, :, :3]).all()
    scale = (qx ** 2).sum(2)[:, :, None] + (cx ** 2).sum(2)[:, None, :]
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 * scale[fin])


def test_distance_tiles_cuda_rejects_cpu_tensors():
    qx, qid, cx, cid = [torch.from_numpy(a) for a in _tiles(2, 4, 12, 3, 0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_tile.distance_tiles_cuda(qx, qid, cx, cid)


@pytest.mark.parametrize("bits,key_dims,d", [(10, 3, 8), (16, 2, 4),
                                             (4, 8, 5)])
def test_cell_keys_bit_identical(bits, key_dims, d):
    rng = np.random.default_rng(bits + d)
    xr = rng.normal(size=(700, d)).astype(np.float32)
    xr[::7, 0] = xr[0, 0]                         # repeated coordinates
    xr[:, -1] = 0.25                              # a flat column: span 0
    want = np.asarray(ref_ann._cell_keys(jnp.asarray(xr), bits, key_dims))
    got = ann._cell_keys(torch.from_numpy(xr), bits, key_dims).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n,k,query", [(777, 15, False), (1024, 200, False),
                                       (600, 10, True)])
def test_probe_layout_bit_identical_given_rotation(n, k, query):
    x = _points(n, 6, n)
    cfg = ref_ann.AnnConfig()
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    rot = np.array(jnp.linalg.qr(jax.random.normal(key, (6, 6)))[0])
    cand = None
    if query:                        # the last 100 rows probe as queries
        cand = np.where(np.arange(n) < n - 100, np.arange(n), -1)
    want = ref_ann._probe_layout(
        jnp.asarray(x), k, key, cfg, 8,
        cand_ids=None if cand is None else jnp.asarray(cand, jnp.int32))
    got = ann._probe_layout(
        torch.from_numpy(x), k, torch.from_numpy(rot), ann.AnnConfig(),
        cand_ids=None if cand is None else torch.from_numpy(cand))
    # the reference pads the tiles to a multiple of its lax.map step (8)
    # with junk tiles; the port streams a partial last chunk instead
    t = got[0].shape[0]
    assert np.all(np.asarray(want[1])[t:] == -1)
    for name, w, g in zip(("qx", "qid", "cx", "cid"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:t],
                                      err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_dedupe_topk_bit_identical():
    """Duplicates (the first occurrence wins), ids −1, tied distances and
    +inf, as tests/test_ann.py's dedupe cases, and a random batch."""
    cases = [([[3, 1, 3, -1, 2]], [[0.5, 0.2, 0.1, 0.0, 0.9]], 3),
             ([[4, 4, -1, -1]], [[1.0, 2.0, 0.0, 0.0]], 3)]
    rng = np.random.default_rng(0)
    cases.append((rng.integers(-1, 20, (64, 40)),
                  rng.choice([0.5, 1.0, 2.0, np.inf], (64, 40)), 12))
    for idx, d2, k in cases:
        idx = np.asarray(idx, np.int32)
        d2 = np.asarray(d2, np.float32)
        wi, wd = ref_ann._dedupe_topk(jnp.asarray(idx), jnp.asarray(d2), k)
        gi, gd = ann._dedupe_topk(torch.from_numpy(idx).long(),
                                  torch.from_numpy(d2), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    mi, md = ann._dedupe_topk(torch.tensor([[3, 1, 3, -1, 2]]),
                              torch.tensor([[0.5, 0.2, 0.1, 0.0, 0.9]]), 3)
    fi, fd = ann._dedupe_topk(torch.cat([mi, mi], 1), torch.cat([md, md], 1),
                              3)
    assert torch.equal(fi, mi) and torch.equal(fd, md)   # a fixpoint


def _graph(n, k, seed, pad=0):
    """A random valid kNN graph (distinct non-self ids, ascending exact
    d²) on blob points, with ``pad`` padded rows (id −1) at the end."""
    rng = np.random.default_rng(seed)
    x = _points(n, 6, seed)
    idx = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                    for i in range(n)])
    d2 = ((x[:, None, :] - x[idx]) ** 2).sum(2)
    order = np.argsort(d2, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, 1).astype(np.int32)
    d2 = np.take_along_axis(d2, order, 1).astype(np.float32)
    rid = np.arange(n + pad, dtype=np.int32)
    rid[n:] = -1
    idx = np.concatenate([idx, np.full((pad, k), -1, np.int32)])
    d2 = np.concatenate([d2, np.full((pad, k), np.inf, np.float32)])
    return x, idx, d2, rid


def test_reverse_sample_bit_identical_given_offsets():
    n, k, m, r = 300, 12, 4, 8
    _, idx, _, rid = _graph(n, k, 1, pad=20)
    key = jax.random.PRNGKey(5)
    want = ref_ann._reverse_sample(jnp.asarray(idx), jnp.asarray(rid), key,
                                   m, r, n)
    off = np.array(jax.random.randint(key, (n,), 0, 1 << 30))
    got = ann._reverse_sample(torch.from_numpy(idx).long(),
                              torch.from_numpy(rid).long(),
                              torch.from_numpy(off), m, r, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refine_chunk_given_same_draws():
    n, k, pad = 400, 10, 12
    cfg = ref_ann.AnnConfig(sample=4)
    x, idx, d2, rid = _graph(n, k, 2, pad=pad)
    kr, kc = jax.random.split(jax.random.PRNGKey(9))
    rev = ref_ann._reverse_sample(jnp.asarray(idx), jnp.asarray(rid), kr,
                                  cfg.sample, k, n)
    rows = slice(100, n + pad)                   # a block ending in padding
    refine = jax.jit(ref_ann._refine_chunk,
                     static_argnames=("cfg", "k", "n", "rows_per", "rpp"))
    wi, wd, wc = refine(
        jnp.asarray(x), jnp.asarray(idx), rev, jnp.asarray(idx[rows]),
        jnp.asarray(d2[rows]), jnp.asarray(rid[rows]), kc, cfg=cfg, k=k,
        n=n, rows_per=n + pad, rpp=n + pad)
    ndraw = cfg.sample + 2 * cfg.sample ** 2
    draws = np.array(jax.vmap(lambda r_: jax.random.randint(
        jax.random.fold_in(kc, r_), (ndraw,), 0, k))(
            jnp.maximum(jnp.asarray(rid[rows]), 0)))
    t = {a: torch.from_numpy(v).long() for a, v in
         (("idx", idx), ("rid", rid), ("draws", draws))}
    gi, gd, gc = ann._refine_chunk(
        torch.from_numpy(x), t["idx"], torch.from_numpy(np.array(rev)).long(),
        t["idx"][rows], torch.from_numpy(d2[rows]), t["rid"][rows],
        t["draws"], ann.AnnConfig(sample=4), k, n)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    assert int(gc) == int(wc) > 0


def test_ann_knn_graph_matches_reference_given_draws():
    """Uniform points and a thin stage 1 (one probe, 32-row tiles), so
    that NN-descent runs every round and does the work."""
    n, d, k, kw = 2048, 8, 15, dict(probes=1, bucket=32)
    x = np.random.default_rng(5).uniform(size=(n, d)).astype(np.float32)
    cfg = ref_ann.AnnConfig(**kw)
    wi, wd = ref_ann.ann_knn_graph(jnp.asarray(x), k, cfg)
    draws = carry.ann_draws_from_numpy(*par.ann_draws(cfg, n, d, k))
    stats = {}
    gi, gd = ann.ann_knn_graph(torch.from_numpy(x), k, ann.AnnConfig(**kw),
                               draws=draws, stats=stats)
    assert gi.shape == (n, k) and gi.dtype == torch.int64
    assert _overlap(gi, wi) >= 0.99
    same = gi.numpy() == np.asarray(wi)
    np.testing.assert_allclose(gd.numpy()[same], np.asarray(wd)[same],
                               rtol=0, atol=1e-5)
    assert stats["descent_iters"] == len(stats["descent_changed"]) >= 2
    assert stats["stage1_s"] >= 0 and stats["descent_s"] >= 0


@pytest.mark.parametrize("n", [512, 777, 1024])
@pytest.mark.parametrize("k", [8, 15, 32])
def test_ann_recall_at_least_090(n, k):
    x = torch.from_numpy(_points(n, 6, n + k))
    ei, _ = neighbors.knn_graph(x, k)
    ai, ad = neighbors.knn_graph(x, k, method="ann")
    assert ai.shape == (n, k) and bool(torch.isfinite(ad).all())
    assert _overlap(ai, ei) >= 0.9


def test_ann_matches_exact_at_tiny_n():
    """One window covers the whole set: stage 1 is exact and NN-descent a
    fixpoint."""
    x = torch.from_numpy(_points(100, 4, 3))
    ei, ed = neighbors.knn_graph(x, 7)
    ai, ad = neighbors.knn_graph(x, 7, method="ann")
    assert torch.equal(ai, ei)
    np.testing.assert_allclose(ad.numpy(), ed.numpy(), atol=1e-4)
    ci, cd = ann.ann_knn_graph(x[:9], 50)            # k clamps to N − 1
    assert ci.shape == (9, 8) and torch.equal(ci, neighbors.knn_graph(
        x[:9], 50)[0])


def _brute_query(q, x, k):
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def test_knn_query_exact_matches_reference():
    x = _points(300, 5, 11)
    q = np.concatenate([x[:16], _points(40, 5, 12)])
    wi, wd = ref_neighbors.knn_query(jnp.asarray(q), jnp.asarray(x), 6)
    gi, gd = neighbors.knn_query(torch.from_numpy(q), torch.from_numpy(x), 6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # fp32 |a|²+|b|²−2ab cancellation leaves ~1e-2 noise at blob scale
    # (tests/test_ann.py's own bar): an identity query's d² of 0 comes
    # out as up to ~1e-5 on one side and 0 on the other
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-2)
    np.testing.assert_array_equal(gi.numpy()[:16, 0], np.arange(16))
    assert neighbors.knn_query(torch.from_numpy(q[:4]),
                               torch.from_numpy(x[:5]), 50)[0].shape == (4, 5)


def test_ann_knn_query_recall_identity_and_reference():
    """Recall ≥ 0.9 against brute force, the corpus-graph expansion only
    helps, identity queries keep their twin (tests/test_ann.py), and
    given the reference's rotations the probe stage agrees with it."""
    x = _points(900, 6, 21)
    q = np.concatenate([x[:32], _points(200, 6, 22)])
    brute = _brute_query(q, x, 10)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    ai, _ = neighbors.knn_query(tq, tx, 10, method="ann")
    base = _overlap(ai, brute)
    assert base >= 0.9
    gi, _ = ann.ann_knn_graph(tx, 10)
    ei, ed = ann.ann_knn_query(tq, tx, 10, corpus_graph=gi)
    assert _overlap(ei, brute) >= base - 1e-9
    np.testing.assert_array_equal(ei.numpy()[:32, 0], np.arange(32))
    assert ed.numpy()[:32, 0].max() < 1e-2
    cfg = ref_ann.AnnConfig()
    wi, _ = ref_ann.ann_knn_query(jnp.asarray(q), jnp.asarray(x), 10, cfg)
    rots = carry.ann_draws_from_numpy(par.ann_query_rotations(cfg, 6))
    pi, _ = ann.ann_knn_query(tq, tx, 10, draws=rots)
    assert _overlap(pi, wi) >= 0.99


def test_config_and_unported_mesh():
    assert [f.name for f in dataclasses.fields(ann.AnnConfig)] == [
        f.name for f in dataclasses.fields(ref_ann.AnnConfig)
        if f.name not in ("interpret", "kernel_mode")]
    assert dataclasses.asdict(ann.AnnConfig()) == {
        k: v for k, v in dataclasses.asdict(ref_ann.AnnConfig()).items()
        if k not in ("interpret", "kernel_mode")}
    x = torch.from_numpy(_points(50, 3, 0))
    with pytest.raises(ValueError, match="tile backend"):
        ann.ann_knn_graph(x, 5, ann.AnnConfig(tile="cuda"))
    # the mesh build (P12b) runs; without a process group it is refused
    with pytest.raises(ValueError, match="torch.distributed initialized"):
        neighbors.knn_graph(x, 5, method="ann", mesh=2)


def test_descent_draws_do_not_depend_on_the_blocking():
    """The port's own slot draws hash (seed, round, row, slot): a build
    in 64-row blocks equals one in a single block."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(500, 6)).astype(np.float32))
    cfg = ann.AnnConfig(probes=1, bucket=32)
    a = ann.ann_knn_graph(x, 10, cfg)
    b = ann.ann_knn_graph(x, 10, dataclasses.replace(cfg, block=64))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_whole_pipeline_on_the_ann_graph():
    par.assert_tsne_pipelines_agree("sparse", knn_method="ann")
