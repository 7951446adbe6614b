"""The paper's experiment configurations (§IV), as port configs.

* cancer: 52M pixels → 26M after noise cut, 8-dim PCA colors, 25 bins/axis,
  16×2·10⁵ sketch, top 20,000 heavy hitters → UMAP 2-D.
* sdss:   30M stars, 10 color-difference features, 22 bins/axis,
  2,609 heavy hitters → UMAP 4-D.

* cancer_error_eval: the error-vs-rank evaluation (§III-2): 22 bins, a
  top-20k query set.
* cancer_100k: beyond the paper, the reference's own configuration for
  10⁵ heavy hitters: sparse tSNE (kNN attraction + FFT grid repulsion).
* sdss_100k: 10⁵ SDSS heavy hitters, UMAP 4-D.
* cancer_1m: the reference's million-representative configuration:
  sparse tSNE on the approximate kNN graph, adaptive grid up to G = 1024.

Column counts are rounded to powers of two (2¹⁸ = 262144 ≈ 2·10⁵) so the
bucket hash is a shift.
"""
from repro_torch.core.pipeline import SnsConfig

CANCER = SnsConfig(
    bins=25, rows=16, log2_cols=18, top_k=20_000,
    replica_scheme="count", max_replicas=8, jitter_frac=0.25,
    embedder="umap", embed_dims=2)

SDSS = SnsConfig(
    bins=22, rows=16, log2_cols=18, top_k=2_609,
    replica_scheme="count", max_replicas=8, jitter_frac=0.25,
    embedder="umap", embed_dims=4)

# Error-vs-rank evaluation (paper §III-2): 22 bins, top-20k query set
CANCER_ERROR_EVAL = SnsConfig(
    bins=22, rows=16, log2_cols=18, top_k=20_000,
    embedder="umap", embed_dims=2)

# Beyond the paper: 10⁵ heavy hitters embedded by the sparse tSNE backend
# (kNN attraction, FFT-grid repulsion; src/repro/configs/sns_paper.py).
CANCER_100K = SnsConfig(
    bins=32, rows=16, log2_cols=20, top_k=100_000,
    replica_scheme="count", max_replicas=4, jitter_frac=0.25,
    embedder="tsne", embed_dims=2,
    embed_backend="sparse", embed_block=512, embed_knn=90, embed_grid=128)

# 10⁵ SDSS heavy hitters.  embed_backend is read by the tSNE branch only
# (pipeline.resolve_embed_cfg), as in the reference.
SDSS_100K = SnsConfig(
    bins=28, rows=16, log2_cols=20, top_k=100_000,
    replica_scheme="count", max_replicas=4, jitter_frac=0.25,
    embedder="umap", embed_dims=4,
    embed_backend="tiled", embed_block=2048)

# The million-representative regime (src/repro/configs/sns_paper.py):
# k = 3·perplexity from the approximate kNN engine (core.ann), adaptive
# grid from G = 256, cell spacing ≤ 0.5 embedding units, G ≤ 1024.
CANCER_1M = SnsConfig(
    bins=48, rows=16, log2_cols=22, top_k=1_000_000,
    replica_scheme="count", max_replicas=1, jitter_frac=0.25,
    embedder="tsne", embed_dims=2,
    embed_backend="sparse", embed_block=1024, embed_knn=0, embed_grid=256,
    embed_grid_interval=0.5, embed_grid_max=1024,
    embed_knn_method="ann")
