"""An embedder's stage captures and checks, one module an embedder (see
``umap.py`` for what a stage module provides)."""
