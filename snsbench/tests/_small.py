"""Small versions of the cells for the CPU tests: the configurations as
the files state them, cut in points, heavy hitters and iterations; and a
small sparse-tSNE configuration that drives the ``tsne_sparse`` stage
module, which no cell uses yet."""
import time

SMALL = {
    "cancer.resident": {
        "data": {"points": 120_000}, "sns": {"top_k": 400},
        "umap": {"n_epochs": 6}},
    "sdss.resident": {
        "data": {"points": 120_000}, "sns": {"top_k": 300},
        "umap": {"n_epochs": 6}},
}
SEED = 2_147_483_659          # past 32 signed bits, as the driver's are

TSNE = {
    "sns": {"bins": 25, "rows": 16, "log2_cols": 22, "top_k": 2000,
            "candidate_pool": 0, "replica_scheme": "count",
            "max_replicas": 1, "jitter_frac": 0.25, "embedder": "tsne",
            "embed_dims": 2, "embed_backend": "sparse", "embed_block": 1024,
            "embed_knn": 0, "embed_grid": 256, "embed_grid_interval": 0.5,
            "embed_grid_max": 1024, "embed_knn_method": "ann"},
    "tsne": {"dims": 2, "perplexity": 30.0, "n_iter": 8,
             "early_exaggeration": 12.0, "exaggeration_iters": 3,
             "learning_rate": 200.0, "momentum_start": 0.5,
             "momentum_final": 0.8, "momentum_switch": 3, "min_gain": 0.01,
             "sigma_search_iters": 50, "adaptive_interval": 3},
    "ann": {"probes": 4, "bucket": 128, "bits": 10, "key_dims": 3,
            "iters": 4, "sample": 16, "delta": 0.002, "rev_cols": 32,
            "block": 4096, "auto_threshold": 65536},
    "warmup": {"tsne": {"n_iter": 3}, "fft_grids": []},
    "check": {"stages": "tsne_sparse", "sample_rows": 4096,
              "limits": {"hh_mismatch": 0, "rep_gap": 0.001,
                         "knn_miss": 0.1, "knn_dist_gap": 0.02,
                         "p_gap": 0.0001, "grad_gap": 0.001,
                         "update_gap": 1e-05}},
}


def run_small(cell, traced=False, control=None, seconds=0.5, fault=None):
    """One run of ``cell`` on the CPU."""
    from snsbench import harness
    return harness.run_cell(cell, SEED, seconds, traced,
                            t_start=time.perf_counter(), device="cpu",
                            cfg_override=SMALL[cell], control=control,
                            fault=fault)


def run_tsne_small(control=None, fault=None, seconds=0.5):
    """One run of :data:`TSNE` (cancer's data cut to 120 000 points) under
    the ``resident`` mix on the CPU, reporting ``cancer.resident``'s
    metrics."""
    from snsbench import harness, program, spec
    cfg = program.merge(spec.config("cancer"),
                        {"data": {"points": 120_000}})
    cfg.pop("umap")
    cfg.update(TSNE)
    return harness.run("cancer.resident", cfg, spec.traffic("resident"),
                       SEED, seconds, False, t_start=time.perf_counter(),
                       device="cpu", control=control, fault=fault)
