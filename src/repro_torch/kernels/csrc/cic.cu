// Cloud-in-cell splat (K2) and gather (K3) for the sparse tSNE backend's
// FFT repulsion grid.  A point p sits in cell (ix, iy) = i0[p] in [0, G-2]
// at fractional offset (fx, fy) = f[p]; its four corner weights are
//   w00 = (1-fx)(1-fy)  w01 = (1-fx)fy  w10 = fx(1-fy)  w11 = fx fy
// at grid cells (ix, iy), (ix, iy+1), (ix+1, iy), (ix+1, iy+1).
//
//   splat:  out[c, ix+dx, iy+dy] += w_{dx dy} * vals[p, c]   (C, G, G)
//   gather: out[p, c] = sum over the corners of w_{dx dy} * fields[c, ...]
//
// Replaces: repro/kernels/cic.py:_splat_kernel and _gather_kernel (the
// Pallas TPU kernels behind cic_splat / cic_gather).  Those built one-hot
// (B, G) weight matrices per point tile and ran both directions as MXU
// matmuls, O(G^2) multiply-adds per point, because scatter stalls a TPU
// (cic.py:1-28 calls it a workaround).  Hopper has fast global atomics and
// caches, so here each point does its own O(C) stencil: one thread per
// point, no one-hot matrices.
//
// K2 design: one thread per point adds its 4*C products with float
// atomicAdd straight into the zeroed (C, G, G) grid in device memory.  The
// order of the additions into a cell depends on the schedule, so the sum
// varies in its last bits from run to run; against the float64 plain
// version a cell is within 1e-5 * (sum of |contributions| to it) + 1e-6.
// A privatised grid in shared memory (3*128*128*4 B = 196 KB at G = 128,
// which needs the dynamic shared-memory opt-in and does not fit at
// G >= 256) is left for when measurements show contention in the way.
// Bound: memory.  The call must read N*(8 + 8 + 4C) bytes and write
// C*G*G*4; the atomics resolve in L2 (the grid is 196 KB at G = 128).  At
// path S's shapes (N = 207 759, G = 128, C = 3) that is 1.80 us; the
// kernel took 43.66 us (chip_smoke, NVIDIA H100 80GB HBM3, 700 W), 24x:
// the points fall in 10 912 of 16 384 cells, up to 117 in one, and the
// atomics on a hot cell serialise.
//
// K3 design: one thread per point reads its cell and offsets as one int2
// and one float2, then the four corners of the fields, which it takes in
// an interleaved (G, G, C) layout: at C = 4 (the main path: conv1's three
// channels and conv0) each corner is one float4 load, four vector gathers
// a point instead of 16 scalar ones, and the point's C outputs are one
// float4 store; another C runs a per-channel loop over the same layout.
// The fields are L2-resident (256 KB at G = 128, 16 MB at G = 1024).  The
// products and sums are rounded one by one (__fmul_rn/__fadd_rn, no fused
// multiply-add) in the plain version's order, starting from 0, so the
// result equals the float32 plain version bit for bit.  Deterministic.
// Bound: memory, N*(8 + 8 + 4C) bytes plus the fields' C*G*G*4: 2.06 us
// at path S's shapes (C = 4).  The design this replaces (C separate
// (G, G) planes, 16 scalar gathers and C strided scalar stores a point)
// took 8.28 us there and F.grid_sample 7.11 us (chip_smoke, NVIDIA H100
// 80GB HBM3, 700.00 W); PERF.md keeps this design's times beside them.
//
// Contract: i0 in [0, G-2] (tsne._cic_weights clips to it).  A point
// outside it is skipped (splat) or reads as 0 (gather) instead of
// touching memory outside the grid.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Corners {
  long long base;  // flat index of corner (ix, iy) in one G x G field
  float w00, w01, w10, w11;
  bool ok;
};

__device__ __forceinline__ Corners corners(int ix, int iy, float fx,
                                           float fy, int g) {
  Corners k;
  k.ok = ix >= 0 && ix <= g - 2 && iy >= 0 && iy <= g - 2;
  k.base = static_cast<long long>(ix) * g + iy;
  const float ox = __fsub_rn(1.0f, fx);
  const float oy = __fsub_rn(1.0f, fy);
  k.w00 = __fmul_rn(ox, oy);
  k.w01 = __fmul_rn(ox, fy);
  k.w10 = __fmul_rn(fx, oy);
  k.w11 = __fmul_rn(fx, fy);
  return k;
}

// One channel's corner sum in the plain version's order, each product and
// sum rounded on its own.
__device__ __forceinline__ float bilinear(const Corners& k, float v00,
                                          float v01, float v10, float v11) {
  float acc = 0.0f;
  acc = __fadd_rn(acc, __fmul_rn(k.w00, v00));
  acc = __fadd_rn(acc, __fmul_rn(k.w01, v01));
  acc = __fadd_rn(acc, __fmul_rn(k.w10, v10));
  acc = __fadd_rn(acc, __fmul_rn(k.w11, v11));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
cic_splat_kernel(const int* __restrict__ i0, const float* __restrict__ f,
                 const float* __restrict__ vals, long long n, int c, int g,
                 float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= n) return;
  const Corners k = corners(i0[2 * p], i0[2 * p + 1], f[2 * p], f[2 * p + 1],
                            g);
  if (!k.ok) return;
  const long long gg = static_cast<long long>(g) * g;
  for (int ch = 0; ch < c; ++ch) {
    const float v = vals[p * c + ch];
    float* o = out + ch * gg + k.base;
    atomicAdd(o, __fmul_rn(k.w00, v));
    atomicAdd(o + 1, __fmul_rn(k.w01, v));
    atomicAdd(o + g, __fmul_rn(k.w10, v));
    atomicAdd(o + g + 1, __fmul_rn(k.w11, v));
  }
}

// fields (g, g, c) interleaved; C = 4 fixed (float4 corners and store)
// or C = 0 (any c, one channel at a time)
template <int C>
__global__ void __launch_bounds__(kThreads)
cic_gather_kernel(const float* __restrict__ fields,
                  const int* __restrict__ i0, const float* __restrict__ f,
                  long long n, int c, int g, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= n) return;
  const int2 cell = reinterpret_cast<const int2*>(i0)[p];
  const float2 off = reinterpret_cast<const float2*>(f)[p];
  const Corners k = corners(cell.x, cell.y, off.x, off.y, g);
  if constexpr (C == 4) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k.ok) {
      const float4* fl = reinterpret_cast<const float4*>(fields) + k.base;
      const float4 v00 = fl[0];
      const float4 v01 = fl[1];
      const float4 v10 = fl[g];
      const float4 v11 = fl[g + 1];
      acc.x = bilinear(k, v00.x, v01.x, v10.x, v11.x);
      acc.y = bilinear(k, v00.y, v01.y, v10.y, v11.y);
      acc.z = bilinear(k, v00.z, v01.z, v10.z, v11.z);
      acc.w = bilinear(k, v00.w, v01.w, v10.w, v11.w);
    }
    reinterpret_cast<float4*>(out)[p] = acc;
  } else {
    const float* fl = fields + k.base * c;
    const long long row = static_cast<long long>(g) * c;
    for (int ch = 0; ch < c; ++ch) {
      out[p * c + ch] = k.ok ? bilinear(k, fl[ch], fl[c + ch],
                                        fl[row + ch], fl[row + c + ch])
                             : 0.0f;
    }
  }
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// i0 (n, 2) int32, f (n, 2) fp32, vals (n, c) fp32, all row-major; out
// (c, g, g) fp32, zeroed by the caller.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int cic_splat_f32(const void* i0, const void* f, const void* vals,
                             long long n, long long c, long long g,
                             void* out, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cic_splat_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(i0), static_cast<const float*>(f),
      static_cast<const float*>(vals), n, static_cast<int>(c),
      static_cast<int>(g), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// fields (g, g, c) fp32 interleaved (16-byte aligned at c = 4), i0/f as
// above (8-byte aligned); out (n, c) fp32.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int cic_gather_f32(const void* fields, const void* i0,
                              const void* f, long long n, long long c,
                              long long g, void* out, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  const float* fl = static_cast<const float*>(fields);
  const int* ip = static_cast<const int*>(i0);
  const float* fp = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 4) {
    cic_gather_kernel<4><<<blocks_for(n), kThreads, 0, s>>>(
        fl, ip, fp, n, 4, static_cast<int>(g), o);
  } else {
    cic_gather_kernel<0><<<blocks_for(n), kThreads, 0, s>>>(
        fl, ip, fp, n, static_cast<int>(c), static_cast<int>(g), o);
  }
  return static_cast<int>(cudaGetLastError());
}
