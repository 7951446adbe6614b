"""The port's first slice end to end (repro_torch.core.pipeline.run) against
the JAX reference at a tiny size, with every random draw carried across:
the same heavy hitters and representatives, bit for bit, and an
embedding within 1e-4.

The embedding bar holds at one replica per cell.  With several jittered
replicas a fraction of a cell apart, the fp32 Gram-identity distances
(summed in different orders by XLA and by torch) differ in their last
bits relative to tiny pair distances, the fuzzy set turns that into
~1e-4 membership differences, and three SGD epochs amplify them; the
module-level bars for that path are in test_torch_umap.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import pipeline as ref_pipeline
from repro.core import umap as ref_umap
from repro.data.synthetic import MixtureSpec as RefSpec
from repro.data.synthetic import gaussian_mixture as ref_mixture
from repro_torch import carry
from repro_torch.configs import sns_paper
from repro_torch.core import pipeline, umap
from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture


def _port_cfg(ref_cfg, **kw):
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg) if f.name != "kernel_mode"}
    fields.update(kw)
    return pipeline.SnsConfig(**fields)


@pytest.mark.parametrize("max_replicas", [1, 8])
def test_run_matches_reference_given_draws(max_replicas):
    pts, _ = gaussian_mixture(4000, MixtureSpec(dims=4), seed=3)
    ref_cfg = ref_pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=64,
                                     max_replicas=max_replicas)
    ucfg = dict(n_neighbors=5, n_epochs=3)
    ref = ref_pipeline.run(ref_cfg, jnp.asarray(pts),
                           umap_cfg=ref_umap.UmapConfig(**ucfg))
    n = ref.embedding.shape[0]
    init, negs = par.umap_draws(par.embed_key(ref_cfg.seed), n, n * 5, 2,
                                3, 5)
    draws = carry.draws_from_numpy(
        hash_params=par.hash_params(ref_cfg.seed, ref_cfg.rows),
        jitter=par.replica_jitter(ref_cfg.seed, ref.hh.key_hi, ref.hh.key_lo,
                                  max_replicas, 4, ref_cfg.jitter_frac),
        umap_init=init, negatives=negs)
    got = pipeline.run(_port_cfg(ref_cfg), pts, device="cpu", draws=draws,
                       umap_cfg=umap.UmapConfig(**ucfg))
    for f in ref.hh._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.hh, f)).astype(np.float64),
            getattr(got.hh, f).numpy().astype(np.float64), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.reps.mask),
                                  got.reps.mask.numpy())
    np.testing.assert_array_equal(ref.rep_weight, got.rep_weight.numpy())
    np.testing.assert_array_equal(ref.rep_hh_id, got.rep_hh_id.numpy())
    rp = np.asarray(ref.reps.points)
    assert np.all(np.abs(rp - got.reps.points.numpy()) <= np.spacing(
        np.abs(rp)))
    assert (got.coverage, got.hh_error_bound) == (ref.coverage,
                                                  ref.hh_error_bound)
    assert set(got.stage_seconds) == {"sketch", "replicas", "embed"}
    emb = got.embedding.numpy()
    assert emb.shape == ref.embedding.shape and np.isfinite(emb).all()
    if max_replicas == 1:
        np.testing.assert_allclose(emb, np.asarray(ref.embedding), rtol=0,
                                   atol=1e-4)


def test_synthetic_data_and_paper_configs_match_reference():
    spec = dict(dims=5, n_clusters=4, background_frac=0.2)
    p, lab = gaussian_mixture(3001, MixtureSpec(**spec), seed=7)
    rp, rlab = ref_mixture(3001, RefSpec(**spec), seed=7)
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(lab, rlab)
    from repro.configs import sns_paper as ref_paper
    for name in ("CANCER", "SDSS", "CANCER_100K"):
        ref = dataclasses.asdict(getattr(ref_paper, name))
        assert ref.pop("kernel_mode") == "auto"
        assert dataclasses.asdict(getattr(sns_paper, name)) == ref


BAD = [dict(bins=1), dict(rows=0), dict(log2_cols=0), dict(log2_cols=32),
       dict(top_k=0), dict(candidate_pool=-1), dict(ingest_chunk=0),
       dict(ingest_superbatch=0), dict(replica_scheme="zipf"),
       dict(max_replicas=0), dict(jitter_frac=1.5), dict(embedder="pca"),
       dict(embed_dims=0), dict(embed_backend="fast"), dict(embed_block=0),
       dict(embed_knn=-1), dict(embed_grid=1), dict(embed_grid_interval=-1.0),
       dict(embed_grid=256, embed_grid_max=128), dict(embed_cic="cuda"),
       dict(embed_knn_method="hnsw")]


@pytest.mark.parametrize("bad", BAD)
def test_config_fails_loud_like_reference(bad):
    with pytest.raises(ValueError) as ref_err:
        ref_pipeline.SnsConfig(**bad)
    with pytest.raises(ValueError) as err:
        pipeline.SnsConfig(**bad)
    assert str(err.value) == str(ref_err.value)


def test_config_has_the_reference_fields_less_kernel_mode():
    """The port's kernels are chosen by the tensors' device, so the
    reference's kernel-tier knob has no counterpart."""
    ref = [f.name for f in dataclasses.fields(ref_pipeline.SnsConfig)]
    assert [f.name for f in dataclasses.fields(pipeline.SnsConfig)] == [
        n for n in ref if n != "kernel_mode"]
    assert "kernel_mode" not in {
        f.name for f in dataclasses.fields(umap.UmapConfig)}
    with pytest.raises(TypeError):
        pipeline.SnsConfig(kernel_mode="auto")


def test_unported_paths_raise_with_their_roadmap_item():
    pts, _ = gaussian_mixture(500, MixtureSpec(dims=3), seed=1)
    cfg = pipeline.SnsConfig(bins=4, rows=2, log2_cols=6, top_k=8)
    small = dict(umap_cfg=umap.UmapConfig(n_neighbors=3, n_epochs=1))
    cases = [
        (dataclasses.replace(cfg, embedder="tsne", embed_backend="sparse",
                             embed_knn_method="ann"), pts, {}, "P9"),
        (dataclasses.replace(cfg, embedder="tsne", embed_mesh=2), pts, {},
         "P12"),
        (dataclasses.replace(cfg, embed_mesh=2), pts, {}, "P12"),
        (cfg, pts, {"mesh": 2}, "P12"),
        (cfg, iter([pts]), {}, "P11"),
        (dataclasses.replace(cfg, embed_knn_method="ann"), pts, small, "P9"),
    ]
    for c, p, kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            pipeline.run(c, p, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="P11"):
        pipeline.sketch_stage(cfg, iter([pts]), device="cpu")


def test_entry_points_default_to_the_card():
    """device=None means CUDA; without a card the run stops, it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    pts, _ = gaussian_mixture(200, MixtureSpec(dims=3), seed=1)
    cfg = pipeline.SnsConfig(bins=4, rows=2, log2_cols=6, top_k=8)
    for call in (lambda: pipeline.run(cfg, pts),
                 lambda: pipeline.sketch_stage(cfg, pts)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
