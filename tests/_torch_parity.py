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
