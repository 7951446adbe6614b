#!/usr/bin/env python3
"""K8 ``sketch_estimate_table`` under other gather loads, block sizes and
an L2 access window, on one NVIDIA GPU.

    python3 chip_k8_variants.py [--l2-window]

The port's K8 (``src/repro_torch/kernels/csrc/sketch.cu``) runs a thread
a query: R hashes, R gathers from the (R, C) table, the median in
registers.  Its gathers are scattered 4-byte reads from an L2-resident
table, so the load's cache path and the number of threads in flight are
what might move it.  This script writes variants of that source (the
gather's ``__ldg`` swapped for ``__ldcg`` or a plain load, the block of
128 threads for 64 or 256), builds each with nvcc into
``build/kernels/k8_variants/``, checks that its estimates equal the port
kernel's bit for bit, and times all of them in turns over ``ROUNDS``
rounds, beside ``torch.gather`` of the precomputed (R, Q) int64 buckets
(the gather floor) and ``torch.take`` of the same gathers as flat cell
indices in two orders, a query's R cells together (K8's order) and a
row's Q cells together (``torch.gather``'s).  Shapes: chip_smoke's
candidate pool (R 16, C 2^18, 40 000 explicit keys), phase ``train``'s
T3 chunk (R 8, C 2^20, the keys (0, j), j < 2^24), and that chunk on a
table of half the size.  ``--l2-window`` instead times the port kernel
against an entry that puts the table in the L2's persisting set-aside
(the largest the card allows) for its launch: all of the port's rounds
first, and after each shape the lines demoted and the set-aside given
back, since both outlive a launch.  Device time a call: CUDA events
behind a sleep kernel (chip_smoke's ``card_ms``).  Random tables and
keys from fixed seeds.  Needs one card; takes about a minute.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 5
PORT = "port (__ldg, 128 threads)"
LOAD = "__ldg(table + cell)"
THREADS = "constexpr int kEstimateThreads = 128;"
LAUNCH = "  if (rows == 8) {"
RETURN = "  return static_cast<int>(cudaGetLastError());\n}\n"
# the table in the L2's persisting set-aside for one launch
WINDOW_ON = r"""
  int dev = 0, max_persist = 0, max_window = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize,
                         dev);
  cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                         dev);
  size_t limit = 0;
  cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  if (limit != static_cast<size_t>(max_persist)) {
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, max_persist);
  }
  cudaStreamAttrValue w = {};
  w.accessPolicyWindow.base_ptr = const_cast<void*>(table);
  w.accessPolicyWindow.num_bytes = static_cast<size_t>(
      std::min<long long>((rows << log2_cols) * 4, max_window));
  w.accessPolicyWindow.hitRatio = fminf(
      1.0f, static_cast<float>(max_persist) /
                static_cast<float>(w.accessPolicyWindow.num_bytes));
  w.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  w.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &w);
"""
WINDOW_OFF = r"""  const int rc = static_cast<int>(cudaGetLastError());
  w.accessPolicyWindow.num_bytes = 0;
  cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &w);
  return rc;
}

extern "C" int sketch_l2_reset() {
  const cudaError_t rc = cudaCtxResetPersistingL2Cache();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(
      cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0));
}
"""


def patch(src: str, load=None, threads=None, window=False) -> str:
    """The port's source with one design choice replaced."""
    for anchor in (LOAD, THREADS, LAUNCH, RETURN):
        if anchor not in src:
            raise RuntimeError(f"sketch.cu no longer holds {anchor!r}")
    if load:
        src = src.replace(LOAD, f"{load}(table + cell)")
    if threads:
        src = src.replace(THREADS,
                          f"constexpr int kEstimateThreads = {threads};")
    if window:
        src = "#include <algorithm>\n" + src.replace(
            LAUNCH, WINDOW_ON + LAUNCH)
        head, tail = src.rsplit(RETURN, 1)
        src = head + WINDOW_OFF + tail
    return src


VARIANTS = {
    PORT: {},
    "__ldcg (L2 only)": {"load": "__ldcg"},
    "plain load (L1 allocating)": {"load": "*"},
    "64 threads": {"threads": 64},
    "256 threads": {"threads": 256},
    "__ldcg, 256 threads": {"load": "__ldcg", "threads": 256},
}
WINDOW = {PORT: {}, "L2 window (table persisting)": {"window": True}}
# (tag, R, log2 C, Q, explicit keys, calls a timing)
SHAPES = (("pool R 16, Q 40 000", 16, 18, 40_000, True, 200),
          ("T3 chunk R 8, Q 2^24", 8, 20, 1 << 24, False, 10),
          ("T3 chunk at C 2^19", 8, 19, 1 << 24, False, 10))


def build(variants) -> dict:
    """{name: CDLL}: one nvcc a variant, all started together."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "sketch.cu").read_text()
    out = _build.BUILD_DIR / "k8_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, how) in enumerate(variants.items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(patch(src, **how))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--l2-window", action="store_true",
                    help="time the L2-window entry against the port's")
    window = ap.parse_args(argv).l2_window
    if not torch.cuda.is_available():
        print("chip_k8_variants: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_ms
    from repro_torch.core import hashing, prng
    from repro_torch.kernels import sketch_estimate as se

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k8] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    libs = build(WINDOW if window else VARIANTS)
    fns = {}
    for name, lib in libs.items():
        fn = lib.sketch_estimate_median_f32
        fn.argtypes, fn.restype = se._SIG, ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    for tag, r, l2c, q, explicit, iters in SHAPES:
        params = hashing.make_params(prng.key(r, device=dev), r)
        table = torch.randn((r, 1 << l2c), device=dev, generator=torch
                            .Generator(device=dev).manual_seed(r))
        if explicit:
            gen = torch.Generator(device=dev).manual_seed(q)
            hi = torch.randint(0, 1 << 32, (q,), device=dev, generator=gen)
            lo = torch.randint(0, 1 << 32, (q,), device=dev, generator=gen)
            ptrs = (hi.data_ptr(), lo.data_ptr())
        else:
            lo = torch.arange(q, device=dev)
            hi = torch.zeros_like(lo)
            ptrs = (None, None)
        buckets = hashing.hashes(params, hi, lo, l2c)[0].contiguous()
        cells = (torch.arange(r, device=dev)[:, None] << l2c) | buckets
        orders = {"take, query-major": cells.T.contiguous(),
                  "take, row-major": cells}
        del cells
        outs = {name: torch.empty(q, device=dev) for name in fns}

        def call(name):
            rc = fns[name](table.data_ptr(), *ptrs,
                           *(p.data_ptr() for p in params),
                           outs[name].data_ptr(), None, q, 0, r, l2c,
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        times = {name: [] for name in fns}
        floor = []
        takes = {name: [] for name in orders}
        for name in fns if window else ():
            for _ in range(ROUNDS):
                times[name].append(card_ms(lambda: call(name), iters)[0])
            torch.cuda.synchronize()
        for _ in range(0 if window else ROUNDS):
            for name in fns:
                times[name].append(card_ms(lambda: call(name), iters)[0])
            floor.append(card_ms(lambda: torch.gather(table, 1, buckets),
                                 iters)[0])
            for name, idx in orders.items():
                takes[name].append(card_ms(lambda: torch.take(table, idx),
                                           iters)[0])
        for name in fns:
            call(name)
        torch.cuda.synchronize()
        if window:
            libs["L2 window (table persisting)"].sketch_l2_reset()
        same = {name: torch.equal(o.view(torch.int32),
                                  outs[PORT].view(torch.int32))
                for name, o in outs.items()}
        for name, ts in times.items():
            print(f"[k8] {tag}: {name}: median "
                  f"{statistics.median(ts) * 1e3:.2f} us a call (rounds "
                  f"{[round(t * 1e3, 2) for t in ts]}); bits equal to the "
                  f"port's: {same[name]}", flush=True)
        if floor:
            print(f"[k8] {tag}: gather floor (torch.gather of the (R, Q) "
                  f"int64 buckets) median {statistics.median(floor) * 1e3:.2f}"
                  f" us (rounds {[round(t * 1e3, 2) for t in floor]}); "
                  f"{r * q} gathers", flush=True)
        for name, ts in takes.items() if floor else ():
            print(f"[k8] {tag}: torch.{name} of the flat cells: median "
                  f"{statistics.median(ts) * 1e3:.2f} us (rounds "
                  f"{[round(t * 1e3, 2) for t in ts]})", flush=True)
        del buckets, orders, outs
        if not all(same.values()):
            print(f"chip_k8_variants: a variant's estimates differ at {tag}",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
