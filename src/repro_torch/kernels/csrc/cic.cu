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
// K3 design: one thread per point reads 4 corners for each of the C fields
// (L2-resident: 256 KB at G = 128, C = 4) and writes its C outputs.  The
// products and sums are rounded one by one (__fmul_rn/__fadd_rn, no fused
// multiply-add) in the plain version's order, starting from 0, so the
// result equals the float32 plain version bit for bit.  Deterministic.
// Bound: memory, N*(8 + 8 + 4C) bytes plus the fields' C*G*G*4: 2.06 us
// at path S's shapes (C = 4); the kernel took 8.44 us and F.grid_sample
// 7.00 us (chip_smoke, same card).  Its C outputs are C scalar stores a
// thread, strided by C; one vector store per point is the next step.
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

__device__ __forceinline__ Corners corners(const int* __restrict__ i0,
                                           const float* __restrict__ f,
                                           long long p, int g) {
  Corners k;
  const int ix = i0[2 * p];
  const int iy = i0[2 * p + 1];
  const float fx = f[2 * p];
  const float fy = f[2 * p + 1];
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

__global__ void __launch_bounds__(kThreads)
cic_splat_kernel(const int* __restrict__ i0, const float* __restrict__ f,
                 const float* __restrict__ vals, long long n, int c, int g,
                 float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= n) return;
  const Corners k = corners(i0, f, p, g);
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

__global__ void __launch_bounds__(kThreads)
cic_gather_kernel(const float* __restrict__ fields,
                  const int* __restrict__ i0, const float* __restrict__ f,
                  long long n, int c, int g, float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= n) return;
  const Corners k = corners(i0, f, p, g);
  const long long gg = static_cast<long long>(g) * g;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.0f;
    if (k.ok) {
      const float* fl = fields + ch * gg + k.base;
      acc = __fadd_rn(acc, __fmul_rn(k.w00, fl[0]));
      acc = __fadd_rn(acc, __fmul_rn(k.w01, fl[1]));
      acc = __fadd_rn(acc, __fmul_rn(k.w10, fl[g]));
      acc = __fadd_rn(acc, __fmul_rn(k.w11, fl[g + 1]));
    }
    out[p * c + ch] = acc;
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

// fields (c, g, g) fp32, i0/f as above; out (n, c) fp32.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int cic_gather_f32(const void* fields, const void* i0,
                              const void* f, long long n, long long c,
                              long long g, void* out, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cic_gather_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), static_cast<const int*>(i0),
      static_cast<const float*>(f), n, static_cast<int>(c),
      static_cast<int>(g), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
