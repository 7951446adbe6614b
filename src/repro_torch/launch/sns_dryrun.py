"""Dry run and roofline of the paper's own pipeline at pod scale (the port
of ``repro.launch.sns_dryrun``).

Costs ``geo_extract``'s per-rank program (quantize → pack → Count Sketch
update → local top-L → hierarchical merge of the sketches → all-gather
of the candidates → global top-K) as one rank of the production mesh, on
the ``meta`` device under a fake process group (``launch/dryrun.py``
says how).  A kernel cannot run on the meta device, so the program runs
the kernels' plain twins, which take the same shapes: 512 ranks × 2²⁰
points a step is ≈ 5.4·10⁸ points a step.

    python -m repro_torch.launch.sns_dryrun [--multi-pod] [--rows 16]
        [--log2-cols 18] [--top-k 20000] [--pool 0] [--per-device 1048576]
        [--out results/sns_perf/baseline.json]

The record holds the rank's collective bytes by kind (inside a host and
across hosts), its bytes from the shapes (the points read, the table and
the candidates written, once each; and every op's operands and results,
unfused), its dot FLOPs (none: the pipeline hashes, sorts and scatters)
and the roofline's terms at ``launch/roofline.py``'s H100 defaults.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.core import heavy_hitters as hh_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.geo import sketch_shard
from repro_torch.core.hashing import MulShiftParams
from repro_torch.core.quantize import GridSpec
from repro_torch.core import sketch as sketch_mod
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import OpBytes, fake_group
from repro_torch.launch.mesh import PRODUCTION_SHAPES


def _meta_params(rows: int) -> MulShiftParams:
    return MulShiftParams(*(torch.empty((rows,), dtype=torch.int64,
                                        device="meta") for _ in range(6)))


def cost(*, multi_pod=False, rows=16, log2_cols=18, top_k=20_000, pool=0,
         per_device=1 << 20, dims=8, bins=25) -> dict:
    """One step of the per-rank program on rank 0 of the production mesh:
    a dict of the counts and the roofline (see the module docstring)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    world = math.prod(shape)
    pool = pool or 2 * top_k
    grid = GridSpec(dims=dims, bins=bins, lo=(0.0,) * dims,
                    hi=(1.0,) * dims)
    t0 = time.time()
    with fake_group(world):
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        data_axes = tuple(names)            # every axis carries data
        pts = torch.empty((per_device, dims), dtype=torch.float32,
                          device="meta")
        sk0 = sketch_mod.init(_meta_params(rows), log2_cols)
        with FlopCounterMode(display=False) as flops, \
                mesh_mod.count_collectives() as coll, \
                OpBytes() as moved:
            sk, cands, _ = sketch_shard(sk0, grid, pts, pool)
            hh, merged = hh_mod.distributed_extract(sk, cands, top_k,
                                                    data_axes, mesh)
    c = coll.summary()
    table = sk0.table.numel() * 4
    cand_bytes = sum(t.numel() * t.element_size() for t in cands)
    io = per_device * dims * 4 + 2 * table + world * cand_bytes \
        + sum(t.numel() * t.element_size() for t in hh)
    n_total = world * per_device
    ici = c["total"] - c["cross_host"]
    tc = flops.get_total_flops() / roofline.PEAK_FLOPS
    tm = moved.total / roofline.HBM_BW
    tcl = ici / roofline.ICI_BW + c["cross_host"] / roofline.DCN_BW
    return {
        "config": dict(multi_pod=multi_pod, rows=rows, log2_cols=log2_cols,
                       top_k=top_k, pool=pool, per_device=per_device,
                       dims=dims, bins=bins),
        "devices": world, "points_per_step": n_total,
        "mesh": "(2,16,16)" if multi_pod else "(16,16)",
        "dryrun_s": round(time.time() - t0, 1),
        "counts": {"flops": float(flops.get_total_flops()),
                   "bytes": float(moved.total), "bytes_io": float(io),
                   "collective_bytes": c["total"],
                   "collective_dcn_bytes": c["cross_host"],
                   "collective_ops": c["num_ops"],
                   "per_kind": c["per_kind"]},
        "roofline": {
            "compute_ms": round(tc * 1e3, 3), "memory_ms": round(tm * 1e3, 3),
            "memory_io_ms": round(io / roofline.HBM_BW * 1e3, 3),
            "collective_ms": round(tcl * 1e3, 3),
            "bottleneck": max([("compute", tc), ("memory", tm),
                               ("collective", tcl)], key=lambda x: x[1])[0],
            "points_per_sec_at_bound": n_total / max(tc, tm, tcl),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--log2-cols", type=int, default=18)
    ap.add_argument("--top-k", type=int, default=20_000)
    ap.add_argument("--pool", type=int, default=0,
                    help="candidate pool per shard (0 -> 2*top_k)")
    ap.add_argument("--per-device", type=int, default=1 << 20)
    ap.add_argument("--dims", type=int, default=8)
    ap.add_argument("--bins", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = cost(multi_pod=args.multi_pod, rows=args.rows,
               log2_cols=args.log2_cols, top_k=args.top_k, pool=args.pool,
               per_device=args.per_device, dims=args.dims, bins=args.bins)
    out = json.dumps(rec, indent=1)
    print(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    return rec


if __name__ == "__main__":
    main()
