#!/usr/bin/env python3
"""K5b ``tsne_forces`` with and without its bit-neutral design steps, on
one NVIDIA GPU.

    python3 chip_k5b_steps.py [--rounds R]

Builds ``kernels/csrc/tsne_forces.cu`` three times: with the per-tile
masks and the whole-warp skip both compiled out (``-DSNS_K5B_NO_TILE_MASKS
-DSNS_K5B_NO_EXP_SKIP``: each tile tests each pair, both exps and the
distance in x on every pair), with the masks only, and as the package
ships it (masks, and the skip of 32 x 32 blocks whose box bound puts every
base-2 exponent below -126).  Each runs on path E's operands, made as
chip_smoke.py makes them (``CANCER``'s sketch of the 26M mixture points,
``embed_backend="pallas"``, the final embedding and the calibrated
stats), with the rows in the caller's order and in
``tsne_forces.locality_order`` (which tsne_step_fused applies): device
time per call from torch.profiler over 10 calls, in ``--rounds`` rounds
that run the variants in turn, forwards then backwards.  Neither step
changes a bit, so every variant is held to the shipped kernel's bits.
Also times the order itself.  Prints each variant's registers (ptxas;
n/a where the build was already cached),
the times, the nvidia-smi line and one JSON line.  Needs one card; takes
about 2 minutes.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (name, the -D macros that compile steps out), in design order
VARIANTS = (("none", ("SNS_K5B_NO_TILE_MASKS", "SNS_K5B_NO_EXP_SKIP")),
            ("masks", ("SNS_K5B_NO_EXP_SKIP",)),
            ("masks+skip", ()))


@contextlib.contextmanager
def forces_from(lib):
    """tsne_forces_cuda launching ``lib``'s kernel for the ``with``
    block (the wrapper binds its entries through ``_build.entry``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import tsne_forces as tf
    fn = lib.tsne_forces_f32
    fn.argtypes, fn.restype = tf._F_SIG, ctypes.c_int
    entry = _build.entry
    _build.entry = lambda name, sym, sig: fn if sym == "tsne_forces_f32" \
        else entry(name, sym, sig)
    try:
        yield
    finally:
        _build.entry = entry


def registers(report: str) -> str:
    """ptxas's line for the Dh = 8, dims = 2 force kernel."""
    lines = report.splitlines()
    for k, line in enumerate(lines):
        if "tsne_force_partialILi8ELi2E" in line:
            for used in lines[k:k + 4]:
                if "Used" in used:
                    return used.split("ptxas info    :")[-1].strip()
    return "n/a"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_k5b_steps: needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (N_POINTS, device_ms, locality_operands,
                            log, make_points, nvidia_smi_line, pair_census)
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import pipeline, tsne
    from repro_torch.kernels import _build
    from repro_torch.kernels import tsne_forces as tf

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        reports = dict(zip([v for v, _ in VARIANTS], pool.map(
            lambda v: _build.build_all(["tsne_forces"], v[1])["tsne_forces"],
            VARIANTS)))
    libs = {name: _build.load("tsne_forces", defs) for name, defs in VARIANTS}
    for name, _ in VARIANTS:
        log(f"[k5b] {name}: force kernel (Dh 8, dims 2) "
            f"{registers(reports[name])}")

    device = torch.device("cuda")
    pts, _, _, _ = make_points(device, N_POINTS)
    cfg = dataclasses.replace(CANCER, embedder="tsne", embed_backend="pallas",
                              embed_knn_method="exact")
    ecfg = pipeline.resolve_embed_cfg(cfg)
    res = pipeline.run(cfg, pts, device=device)
    del pts
    x, w = res.reps.points[res.reps.mask], res.rep_weight
    n = x.shape[0]
    st = tsne.calibrate_stats(x, ecfg.perplexity, weights=w,
                              search_iters=ecfg.sigma_search_iters,
                              block=ecfg.block)
    blk = min(ecfg.block, n)
    xp, yp = tf.pad_rows(x, blk), tf.pad_rows(res.embedding, blk)
    sp = tf.step_stats(st.beta, st.zp, st.shift, st.w, blk)
    ordered, order = locality_operands(xp, yp, sp, n)
    operands = {"caller": (xp, yp, sp), "locality": ordered}
    live, skip = pair_census(xp, sp, n, {
        "locality": order, "caller": torch.arange(n, device=device)})
    log(f"[k5b] path E operands: N {n} padded to {xp.shape[0]}, Dh "
        f"{xp.shape[1]}; pairs with an exponent >= -126 (base 2): {live} of "
        f"{n * (n - 1)}; warp column steps needing no exp / 32x32 blocks "
        f"the box bound skips: " + ", ".join(
            f"{k} order {v['column']:.4f} / {v['group']:.4f}"
            for k, v in skip.items()))

    z = tf.tsne_z_cuda(yp, n)
    shipped = {k: tf.tsne_forces_cuda(*ops, z, 1.0, n)
               for k, ops in operands.items()}
    for name, _ in VARIANTS:
        with forces_from(libs[name]):
            for k, ops in operands.items():
                f, parts = tf.tsne_forces_cuda(*ops, z, 1.0, n)
                if not (torch.equal(f, shipped[k][0])
                        and torch.equal(parts, shipped[k][1])):
                    raise AssertionError(f"[k5b] {name}, {k} order: not the "
                                         f"shipped kernel's bits")
        log(f"[k5b] {name}: the shipped kernel's bits in both orders")

    times = {name: {k: [] for k in operands} for name, _ in VARIANTS}
    for r in range(args.rounds):
        turn = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
        for name, _ in turn:
            with forces_from(libs[name]):
                for k, ops in operands.items():
                    times[name][k].append(device_ms(
                        lambda: tf.tsne_forces_cuda(*ops, z, 1.0, n), 10))
    order_ms = device_ms(lambda: tf.locality_order(x), 10)
    for name, _ in VARIANTS:
        log(f"[k5b] {name}: " + "; ".join(
            f"{k} order " + " / ".join(f"{t * 1e3:.2f}" for t in ts) + " us"
            for k, ts in times[name].items()))
    log(f"[k5b] locality_order itself: {order_ms * 1e3:.2f} us a call")
    log(nvidia_smi_line())
    log(json.dumps({"n": n, "n_pad": xp.shape[0], "pairs_live": live,
                    "skip_share": skip, "order_ms": order_ms,
                    "registers": {name: registers(reports[name])
                                  for name, _ in VARIANTS},
                    "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
