#!/usr/bin/env python3
"""Why path A of chip_smoke.py sets the tSNE learning rate and how it holds
the map: the quality of ``CANCER_1M``'s map on one NVIDIA GPU under a
few optimizer settings.

    python3 chip_diag_cancer_1m.py

Runs ``pipeline.run(CANCER_1M)`` on chip_smoke's 26M mixture points at
the default tSNE settings (learning rate 200, 500 iterations), then
``tsne.run_tsne`` on the same 10⁶ representatives with the exact kNN
graph instead of the approximate one, with 1500 iterations, with the
rate N/12, with openTSNE's defaults for large data (rate N/12, 250
exaggerated of 750 iterations: chip_smoke's path A), and with 250
exaggerated iterations at rate 200.  For each map it prints
chip_smoke's blob check (min inter-blob distance over max intra-blob
spread, held > 1.5 on chip_smoke's other paths), the share of reps
nearest their own blob's centroid (the reference's sparse-tSNE contract,
tests/test_sparse_tsne.py, ≥ 0.95), the share of 20 000 sampled reps' 10
nearest map neighbours from their own blob (held ≥ 0.95 on path A), the
span, the KL trace's ends and the seconds.  Needs one card; takes about
4 minutes.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def quality(tag, reps, emb, kl, seconds, centers):
    from chip_smoke import blob_separation, knn_purity, log
    inter, intra, _, acc = blob_separation(reps, emb, centers)
    purity = knn_purity(reps, emb, centers)
    span = (emb.max(0).values - emb.min(0).values).max().item()
    log(f"[diag] {tag}: blob check {inter:.3f} / {intra:.3f} = "
        f"{inter / intra:.3f}; centroid accuracy {acc:.4f}; 10-NN purity "
        f"{purity:.4f}; span {span:.1f}; KL {kl[0].item():.3f} -> "
        f"{kl[-1].item():.3f}; {seconds:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_diag_cancer_1m: needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from chip_smoke import N_POINTS, log, make_points, nvidia_smi_line
    from repro_torch.configs.sns_paper import CANCER_1M
    from repro_torch.core import pipeline, tsne
    from repro_torch.kernels import _build

    _build.build_all()
    device = torch.device("cuda")
    pts, _, _, spec = make_points(device, N_POINTS)
    centers = torch.as_tensor(np.asarray(spec.centers(0), np.float32),
                              device=device)
    t0 = time.perf_counter()
    res = pipeline.run(CANCER_1M, pts, device=device)
    torch.cuda.synchronize()
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    n = x.shape[0]
    quality(f"CANCER_1M as configured ({n} reps, ANN graph, rate 200, 500 "
            f"iterations)", x, res.embedding, res.kl_trace,
            time.perf_counter() - t0, centers)
    ecfg = pipeline.resolve_embed_cfg(CANCER_1M)
    for tag, kw in [
            ("exact kNN graph, rate 200", dict(knn_method="exact")),
            ("ANN graph, rate 200, 1500 iterations", dict(n_iter=1500)),
            (f"ANN graph, rate N/12 = {n / 12:.0f}",
             dict(learning_rate=n / 12)),
            ("ANN graph, openTSNE's defaults: rate N/12, 250 exaggerated "
             "of 750 iterations",
             dict(learning_rate=n / 12, n_iter=750, exaggeration_iters=250,
                  momentum_switch=250)),
            ("ANN graph, rate 200, 250 exaggerated iterations",
             dict(exaggeration_iters=250, momentum_switch=250))]:
        gen = torch.Generator(device=device).manual_seed(CANCER_1M.seed + 1)
        t0 = time.perf_counter()
        y, kl = tsne.run_tsne(x, dataclasses.replace(ecfg, **kw), weights=w,
                              generator=gen)
        torch.cuda.synchronize()
        quality(tag, x, y, kl, time.perf_counter() - t0, centers)
    log(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
