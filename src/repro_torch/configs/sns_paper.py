"""The paper's experiment configurations (§IV), as port configs.

* cancer: 52M pixels → 26M after noise cut, 8-dim PCA colors, 25 bins/axis,
  16×2·10⁵ sketch, top 20,000 heavy hitters → UMAP 2-D.
* sdss:   30M stars, 10 color-difference features, 22 bins/axis,
  2,609 heavy hitters → UMAP 4-D.

* cancer_100k: beyond the paper, the reference's own configuration for
  10⁵ heavy hitters: sparse tSNE (kNN attraction + FFT grid repulsion).

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

# Beyond the paper: 10⁵ heavy hitters embedded by the sparse tSNE backend
# (kNN attraction, FFT-grid repulsion; src/repro/configs/sns_paper.py).
CANCER_100K = SnsConfig(
    bins=32, rows=16, log2_cols=20, top_k=100_000,
    replica_scheme="count", max_replicas=4, jitter_frac=0.25,
    embedder="tsne", embed_dims=2,
    embed_backend="sparse", embed_block=512, embed_knn=90, embed_grid=128)
