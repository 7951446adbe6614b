"""Shared helpers of the tests/test_torch_*.py parity tests: the JAX
reference's random draws, made exactly as the reference makes them, and
handed over as numpy so the port can be held to the reference's result."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import hashing as ref_hashing


def hash_params(seed: int, rows: int):
    """The six uint32 arrays ``sketch.init(jax.random.key(seed), ...)``
    draws (pipeline._sketch_stage_impl)."""
    return [np.array(p) for p in
            ref_hashing.make_params(jax.random.key(seed), rows)]


def replica_jitter(seed: int, key_hi, key_lo, max_replicas: int, dims: int,
                   jitter_frac: float) -> np.ndarray:
    """The cell-keyed jitter of ``replicas.make_representatives`` under
    ``pipeline.embed_stage``'s key: (K, max_replicas, D)."""
    krep, _ = jax.random.split(jax.random.key(seed + 1))

    def one(hi, lo):
        kc = jax.random.fold_in(jax.random.fold_in(krep, hi), lo)
        return jax.random.uniform(kc, (max_replicas, dims),
                                  minval=-jitter_frac, maxval=jitter_frac)
    return np.array(jax.vmap(one)(jnp.asarray(key_hi),
                                    jnp.asarray(key_lo)))


def umap_draws(key, n: int, n_edges: int, dims: int, n_epochs: int,
               neg_rate: int, init_scale: float = 10.0):
    """(init (n, dims), negatives (n_epochs, E, neg_rate)) as
    ``umap._optimize_embedding_jit`` draws them from ``key``."""
    kinit, key = jax.random.split(key)
    init = init_scale * jax.random.uniform(kinit, (n, dims)) \
        - init_scale / 2.0
    negs = []
    for _ in range(n_epochs):
        key, kneg = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(kneg, (n_edges, neg_rate),
                                                  0, n)))
    return np.array(init), np.stack(negs)


def embed_key(seed: int):
    """``pipeline.embed_stage``'s embedder key."""
    return jax.random.split(jax.random.key(seed + 1))[1]


def tsne_init(seed: int, n: int, dims: int) -> np.ndarray:
    """``run_tsne``'s cold start under ``pipeline.embed_stage``'s key:
    1e-4·normal(kembed, (n, dims))."""
    return np.array(1e-4 * jax.random.normal(embed_key(seed), (n, dims)))


def tsne_pipelines(backend: str, n_iter: int):
    """``pipeline.run`` with ``embedder="tsne"`` on ``backend``, in the
    reference and in the port (on the CPU) on the same 4000 points, the
    port given the reference's hash parameters, jitter and tSNE init.

    Four well-separated blobs, a few hundred representatives; the
    learning rate is 10, not 200: at 200 a run of ~180 points blows up
    within 50 iterations in the reference itself (NaN on the sparse
    backend).  Returns (reference result, port result, labels of the
    representatives by their nearest blob centre)."""
    import torch
    from repro.core import pipeline as ref_pipeline
    from repro.core import tsne as ref_tsne
    from repro_torch import carry
    from repro_torch.core import pipeline, tsne
    from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture

    spec = MixtureSpec(dims=4, n_clusters=4, background_frac=0.0,
                       cluster_std=0.05)
    pts, _ = gaussian_mixture(4000, spec, seed=3)
    kw = dict(bins=8, rows=4, log2_cols=10, top_k=96, max_replicas=4,
              embedder="tsne", embed_backend=backend, embed_grid=64,
              embed_block=128)
    tc = dict(n_iter=n_iter, perplexity=10.0, learning_rate=10.0,
              exaggeration_iters=25, momentum_switch=25)
    ref_cfg = ref_pipeline.SnsConfig(**kw)
    ref = ref_pipeline.run(ref_cfg, jnp.asarray(pts),
                           tsne_cfg=ref_tsne.TsneConfig(**tc))
    n = ref.embedding.shape[0]
    draws = carry.draws_from_numpy(
        hash_params=hash_params(ref_cfg.seed, ref_cfg.rows),
        jitter=replica_jitter(ref_cfg.seed, ref.hh.key_hi, ref.hh.key_lo,
                              ref_cfg.max_replicas, 4, ref_cfg.jitter_frac),
        tsne_init=tsne_init(ref_cfg.seed, n, 2))
    got = pipeline.run(pipeline.SnsConfig(**kw), pts, device="cpu",
                       draws=draws, tsne_cfg=tsne.TsneConfig(**tc))
    reps = got.reps.points[got.reps.mask]
    centers = torch.from_numpy(spec.centers(3).astype(np.float32))
    return ref, got, torch.cdist(reps, centers).argmin(1).numpy()


def centroid_accuracy(y: np.ndarray, labels: np.ndarray) -> float:
    """tests/test_sparse_tsne.py's blob-separation measure: the share of
    points nearest their own blob's centroid in the embedding."""
    cents = np.stack([y[labels == c].mean(0) for c in np.unique(labels)])
    d = ((y[:, None, :] - cents[None]) ** 2).sum(-1)
    return float((d.argmin(1) == labels).mean())


def assert_tsne_pipelines_agree(backend: str):
    """The whole-run contract for one backend: heavy hitters and
    representatives identical; the embedding within 1e-3 of the
    reference's after 10 iterations; after 50 (where the chaotic
    optimizer has amplified fp differences) blob separation at least
    the reference's less 0.02 and the exact-objective KL within 5 % of
    the reference's."""
    import torch
    from repro_torch.core import tsne

    ref, got, _ = tsne_pipelines(backend, 10)
    for f in ref.hh._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.hh, f)).astype(np.float64),
            getattr(got.hh, f).numpy().astype(np.float64), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.reps.mask),
                                  got.reps.mask.numpy())
    np.testing.assert_array_equal(ref.rep_weight, got.rep_weight.numpy())
    rp = np.asarray(ref.reps.points)
    assert np.all(np.abs(rp - got.reps.points.numpy())
                  <= np.spacing(np.abs(rp)))
    np.testing.assert_allclose(got.embedding.numpy(),
                               np.asarray(ref.embedding), rtol=0, atol=1e-3)

    ref, got, labels = tsne_pipelines(backend, 50)
    y_ref, y_got = np.asarray(ref.embedding), got.embedding.numpy()
    assert np.isfinite(y_got).all()
    assert centroid_accuracy(y_got, labels) >= min(
        0.95, centroid_accuracy(y_ref, labels) - 0.02)
    x = got.reps.points[got.reps.mask]
    p = tsne.p_from_stats(x, tsne.calibrate_stats(x, 10.0,
                                                  weights=got.rep_weight))
    kl_ref = tsne.kl_divergence(p, torch.from_numpy(y_ref.copy())).item()
    assert tsne.kl_divergence(p, got.embedding).item() <= 1.05 * kl_ref
