#!/usr/bin/env python3
"""Why K7 ``sketch_update_table`` keeps one thread an item: the port's
kernel against a layout that gives a streaming chunk's live items more of
the card, on one NVIDIA GPU.

    python3 chip_k7_layouts.py

The port's K7 (``src/repro_torch/kernels/csrc/sketch.cu``) runs a thread
an item, each hashing its key and adding into all R rows.  The other
layout, built here from the source below, gives a warp 32 items and a
slice of ``row_slice`` of the R rows, so R / row_slice warps share each
group of 32 items (4-16x the warps of a chunk's ~33k live runs); a
group with no live item costs one load.  Both are timed on chip_smoke's
inputs (``gaussian_mixture(26_000_000, dims=8)`` at ``CANCER``'s grid
and hash parameters): path I's first chunk (65 536 run slots) and the
one-shot sketch's runs (26M slots), beside ``index_add_`` of the
precomputed buckets, in turns over 3 rounds (device time a call,
torch.profiler).  The layout at one slice is also built with its atomic
adds compiled out, which shows how much of the time the adds take.  Every
layout's table is checked equal to the port kernel's (integer counts:
bit for bit).  Needs one card; takes about a minute.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3
SLICES = (1, 2, 4, 8, 16)

# A warp: items [32 g, 32 g + 32) and rows [s rs, min((s + 1) rs, R)),
# g = w / slices, s = w % slices.  Parameters staged a warp at a time.
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
struct MulShift { uint64_t a1, a2, b; };
__device__ __forceinline__ uint64_t join(const long long* hi,
                                         const long long* lo, int r) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi[r])) << 32) |
         static_cast<uint32_t>(lo[r]);
}
__device__ __forceinline__ uint64_t mulshift(const MulShift& p,
                                             uint32_t x_hi, uint32_t x_lo) {
  const uint64_t low = p.b +
      static_cast<uint64_t>(static_cast<uint32_t>(p.a1)) * x_hi +
      static_cast<uint64_t>(static_cast<uint32_t>(p.a2)) * x_lo;
  const uint32_t high = static_cast<uint32_t>(p.a1 >> 32) * x_hi +
                        static_cast<uint32_t>(p.a2 >> 32) * x_lo;
  return low + (static_cast<uint64_t>(high) << 32);
}
__global__ void __launch_bounds__(kThreads)
sliced(const long long* key_hi, const long long* key_lo, const float* values,
       const long long* a1h, const long long* a1l, const long long* a2h,
       const long long* a2l, const long long* bh, const long long* bl,
       float* table, long long n, int rows, int row_slice, unsigned slices,
       int log2_cols) {
  extern __shared__ MulShift hp[];
  const int lane = threadIdx.x & 31;
  const unsigned warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const unsigned group = warp / slices;
  const int r0 = static_cast<int>(warp - group * slices) * row_slice;
  const long long i = static_cast<long long>(group) * 32 + lane;
  const float v = i < n ? values[i] : 0.0f;
  if (__ballot_sync(0xffffffffu, v != 0.0f) == 0) return;
  const int cnt = min(row_slice, rows - r0);
  MulShift* wp = hp + (threadIdx.x >> 5) * row_slice;
  for (int r = lane; r < cnt; r += 32) {
    wp[r] = MulShift{join(a1h, a1l, r0 + r), join(a2h, a2l, r0 + r),
                     join(bh, bl, r0 + r)};
  }
  __syncwarp();
  if (v == 0.0f) return;
  const uint32_t x_hi = static_cast<uint32_t>(key_hi[i]);
  const uint32_t x_lo = static_cast<uint32_t>(key_lo[i]);
  for (int r = 0; r < cnt; ++r) {
    const uint64_t h = mulshift(wp[r], x_hi, x_lo);
    const uint64_t cell = (static_cast<uint64_t>(r0 + r) << log2_cols) |
                          (h >> (64 - log2_cols));
#ifdef SNS_NO_ADDS
    if (h == 0x0123456789abcdefull) table[cell] = v;   // never: no adds
#else
    atomicAdd(table + cell, (h >> 63) ? -v : v);
#endif
  }
}
}  // namespace
extern "C" int sliced_f32(const void* hi, const void* lo, const void* v,
                          const void* a1h, const void* a1l, const void* a2h,
                          const void* a2l, const void* bh, const void* bl,
                          void* table, long long n, long long rows,
                          long long row_slice, long long log2_cols,
                          void* stream) {
  const long long slices = (rows + row_slice - 1) / row_slice;
  const long long warps = (n + 31) / 32 * slices;
  sliced<<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kThreads,
           kWarps * row_slice * sizeof(MulShift),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(hi), static_cast<const long long*>(lo),
      static_cast<const float*>(v), static_cast<const long long*>(a1h),
      static_cast<const long long*>(a1l), static_cast<const long long*>(a2h),
      static_cast<const long long*>(a2l), static_cast<const long long*>(bh),
      static_cast<const long long*>(bl), static_cast<float*>(table), n,
      static_cast<int>(rows), static_cast<int>(row_slice),
      static_cast<unsigned>(slices), static_cast<int>(log2_cols));
  return static_cast<int>(cudaGetLastError());
}
"""


def build(defines):
    """The layout's library under build/kernels, one nvcc a variant."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "k7_layouts.cu"
    src.write_text(SOURCE)
    outs = {d: _build.BUILD_DIR / f"k7_layouts{d or ''}.so" for d in defines}
    procs = {d: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *([f"-D{d}"] if d else []),
         "-o", str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for d, out in outs.items()}
    libs = {}
    for d, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the layout ({d}):\n{log}")
        fn = ctypes.CDLL(str(outs[d])).sliced_f32
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[d] = fn
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_k7_layouts: needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (N_POINTS, device_ms, log, make_points,
                            nvidia_smi_line)
    from repro_torch.configs.sns_paper import CANCER
    from repro_torch.core import candidates, hashing, pipeline, quantize
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_update as su

    _build.build_all(["sketch"])
    libs = build([None, "SNS_NO_ADDS"])
    device = torch.device("cuda")
    pts = make_points(device, N_POINTS)[0]
    cfg = CANCER
    hp = pipeline._hash_params(cfg, device, None)
    grid = quantize.fit_grid(pts, cfg.bins)
    r, l2c, step = hp.rows, cfg.log2_cols, cfg.ingest_chunk

    def runs(p):
        kh, kl = quantize.points_to_keys(grid, p)
        rr = candidates.sorted_runs(kh, kl, assume_hi_zero=grid.dims
                                    * grid.bits_per_dim <= 32)
        return (rr.key_hi.contiguous(), rr.key_lo.contiguous(),
                (rr.count * rr.live).contiguous())

    for side, (hi, lo, v), iters in (
            ("chunk", runs(pts[:step].contiguous()), 100),
            ("one-shot", runs(pts), 5)):
        table = torch.zeros((r, 1 << l2c), device=device)
        n = hi.shape[0]

        def layout(rs, define=None, t=table):
            rc = libs[define](hi.data_ptr(), lo.data_ptr(), v.data_ptr(),
                              *(p.data_ptr() for p in hp), t.data_ptr(), n,
                              r, rs, l2c,
                              torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"layout launch failed: CUDA error {rc}")
        want = su.sketch_update_cuda(table.clone(), hp, hi, lo, v)
        for rs in SLICES:
            got = table.clone()
            layout(rs, t=got)
            if not torch.equal(got, want):
                raise AssertionError(f"{side}: the layout at {rs} rows a "
                                     f"warp differs from the port's K7")
        live = (v != 0).nonzero().squeeze(1)
        b, s = hashing.hashes(hp, hi[live], lo[live], l2c)
        idx = ((torch.arange(r, device=device) << l2c)[:, None] | b
               ).reshape(-1)
        vals = (s.float() * v[live][None, :]).reshape(-1)
        del b, s
        flat = table.view(-1)
        fns = {"port K7 (a thread an item)":
               lambda: su.sketch_update_cuda(table, hp, hi, lo, v),
               "index_add_": lambda: flat.index_add_(0, idx, vals)}
        for rs in SLICES:
            fns[f"layout, {rs} rows a warp ({-(-r // rs)} warps a group)"] \
                = lambda rs=rs: layout(rs)
        fns[f"layout, {r} rows a warp, adds compiled out"] = \
            lambda: layout(r, "SNS_NO_ADDS")
        times = {k: [] for k in fns}
        for _ in range(ROUNDS):
            for k, fn in fns.items():
                times[k].append(device_ms(fn, iters))
        adds = live.shape[0] * r
        log(f"[k7] {side}: {n} run slots, {live.shape[0]} live, {adds} "
            f"adds; every layout's table equal to the port K7's")
        for k, ts in times.items():
            med = statistics.median(t for t in ts if t is not None)
            log(f"[k7] {side} {k}: " + " / ".join(
                "n/a" if t is None else f"{t * 1e3:.2f}" for t in ts)
                + f" us; median {med * 1e3:.2f} us"
                + ("" if "compiled out" in k else
                   f", {adds / (med * 1e-3) / 1e9:.1f}e9 adds/s"))
        del idx, vals, table, flat
    log(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
