"""The host tier on the card: shard jobs folding in threads on one GPU.
Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one;
this file imports neither jax nor the reference.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_service.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import geo, hashing, prng, quantize, resilience, stream
from repro_torch.kernels import LAUNCHES


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.kernels import _build
    _build.build_all()          # before any thread reaches a kernel
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("superbatch", [1, 4])
def test_threaded_shard_jobs_merge_to_one_fold(card, superbatch):
    """Four shard jobs through collect_shards, run twice: the merged table
    equals one fold of all the points at the same hash parameters, bit for
    bit, and K7 ran once a folded chunk."""
    rng = np.random.default_rng(0)
    shards = {s: rng.normal(s % 2, 0.2, size=(150_000 + 777 * s, 4)
                            ).astype(np.float32) for s in range(4)}
    grid = quantize.GridSpec(dims=4, bins=16, lo=(-1.5,) * 4, hi=(2.5,) * 4)
    params = hashing.make_params(prng.key(3, device=card), 8)
    chunk, pool = 16_384, 4096
    sources = {s: (lambda p=p: iter([p[:70_001], p[70_001:]]))
               for s, p in shards.items()}
    one = stream.ingest_all(stream.init(params, 14, pool), grid,
                            [p for p in shards.values()], chunk)
    per = [-(-p.shape[0] // (chunk * superbatch)) * superbatch
           for p in shards.values()]
    tables = []
    for _ in range(2):
        jobs = geo.shard_ingest_jobs(
            grid, sources, seed=0, rows=8, log2_cols=14, pool=pool,
            chunk_size=chunk, superbatch=superbatch, device=card,
            hash_params=params)
        LAUNCHES.clear()
        agg = resilience.collect_shards(jobs, verify=True, device=card)
        torch.cuda.synchronize()
        assert LAUNCHES["sketch_update_table"] == sum(per)
        assert agg.coverage == 1.0 and agg.lost == ()
        assert agg.state.sketch.table.is_cuda
        assert float(agg.state.count) == sum(p.shape[0]
                                             for p in shards.values())
        tables.append(agg.state.sketch.table)
    assert torch.equal(tables[0], one.sketch.table)
    assert torch.equal(tables[1], one.sketch.table)
