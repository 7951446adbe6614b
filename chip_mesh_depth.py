#!/usr/bin/env python3
"""Path M alone on the layouts named, and path A's map at cut depths, on
the card.

    python3 chip_mesh_depth.py [--layouts gloo4,nccl1,nccl4]
                               [--depths 100,200,300]

Builds the kernels, makes chip_smoke's 26M points and runs path A (for
the digests path M's step (d) is held to), then prints the 10-NN purity
of path A's map on one device after each of ``--depths`` iterations
(chip_smoke holds ≥ 0.95 at 500), then runs chip_smoke's path M, steps
(a)-(d) under chip_smoke's gates, on the layouts named (default: every
one the visible cards allow; ``nccl4`` needs 4 cards).  With
``--layouts nccl4 --depths ""`` it measures step (d) on four cards
without the rest of chip_smoke (~3 min).  It needs the repository
beside it.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs                                   # noqa: E402


def purity_at_depth(dev, pts, spec, depths):
    """Path A on one device stopped after each of ``depths`` iterations:
    the map's 10-NN purity and blob separation (chip_smoke's measures)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.sns_paper import CANCER_1M
    from repro_torch.core import pipeline
    centers = torch.as_tensor(np.asarray(spec.centers(0), np.float32),
                              device=dev)
    for it in depths:
        tcfg = dataclasses.replace(cs.path_a_tsne_cfg(CANCER_1M), n_iter=it)
        res = pipeline.run(CANCER_1M, pts, device=dev, tsne_cfg=tcfg)
        reps = res.reps.points[res.reps.mask]
        inter, intra, _, acc = cs.blob_separation(reps, res.embedding,
                                                  centers)
        cs.log(f"[depth] path A on one device after {it} iterations: 10-NN "
               f"purity {cs.knn_purity(reps, res.embedding, centers):.4f}, "
               f"centroid accuracy {acc:.4f}, separation {inter:.3f} vs "
               f"{intra:.3f}, KL {res.kl_trace[-1].item():.4f}")
        del res, reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", default="",
                    help="path M layouts to run (default: every one the "
                         "cards allow)")
    ap.add_argument("--depths", default="100,200,300",
                    help="one-device iteration counts to measure")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_depth: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    dev = torch.device("cuda")
    pts, pts_np, warm, spec = cs.make_points(dev, cs.N_POINTS)
    _, _, _, ref_a = cs.phase_ann(dev, pts, warm, spec)
    depths = [int(d) for d in args.depths.split(",") if d]
    purity_at_depth(dev, pts, spec, depths)
    layouts = cs.mesh_layouts(torch.cuda.device_count())
    if args.layouts:
        keep = args.layouts.split(",")
        layouts = [lay for lay in layouts if lay[0] in keep]
    cs.phase_mesh(dev, pts, pts_np, spec, ref_a, layouts=layouts)
    cs.log(f"[depth] whole run {time.perf_counter() - t0:.1f} s; "
           f"{cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
