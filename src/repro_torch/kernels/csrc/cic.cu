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
// K2 design: fixed-point integer accumulation, so that the grid does not
// depend on the schedule.  Three kernels on one stream:
//   1. abs_bound: m = max over points of max_c |v_pc| * S(f_p), with
//      S(f) = (|1-fx| + |fx|) (|1-fy| + |fy|) >= the point's sum of |corner
//      weights| (1 for f in [0, 1]); one integer atomicMax a block on the
//      float's bits (non-negative floats order as their bits do, so the max
//      is the same in any order; NaN's bits exceed +inf's).
//   2. splat: every thread reads m and takes the scale 2^s, s the
//      largest integer with 2^s < 2^60 / (N m) (from frexp): so
//      4 N m 2^s < 2^62.  Each corner product fl32(w v) is scaled by 2^s
//      in double (exact) and rounded to the nearest int64.  A cell gets at
//      most the products of all N points, whose magnitudes sum to at most
//      N m (1 + 2^-22) before scaling, plus 1/2 each for the rounding:
//      |cell| < 2^60 (1 + 2^-22) + N < 2^61 for any N < 2^31, so no cell
//      overflows the 64-bit two's-complement sum.  The lanes of
//      a warp whose points share a cell first sum their integers by a
//      shuffle tree over the group (__match_any_sync), and one lane adds
//      the group's 4C sums with 64-bit atomicAdd (zeros skipped): fewer L2
//      atomics on hot cells.  Integer addition is associative, so the sum
//      is the same in any order.
//   3. to_float: each cell once, fl32(fl64(acc) * 2^-s).  A non-finite m
//      (a NaN or infinite input) turns the whole grid into NaN.
// The result is deterministic, bit for bit, at any N and G.  Against the
// float64 plain version a cell is off by at most 2^-23 of the sum of
// |contributions| to it (the products' and the last conversion's
// roundings) plus k 2^-(s+1) for its k contributions, k 2^-(s+1) < k N m /
// 2^60: under 1e-5 * (sum of |contributions|) + 1e-6 while N m stays well
// under 2^60 * 1e-6 ~ 1.2e12 (path A: N = 10^6 points, |y| of a few
// hundred).  cic_splat_torch, the plain version and the CPU path, stays
// the reference's float splat; nothing is quantized there.
// Bound: memory.  The call must read N*(8 + 8 + 4C) bytes and write
// C*G*G*4: 1.80 us at path S's shapes (N = 207 759, G = 128, C = 3).  The
// float-atomic design this replaces took 49.42 us there, index_add_ 48.05
// us (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W): the points fall in
// ~10 900 of 16 384 cells, up to ~117 in one, and the atomics on a hot
// cell serialise.  This design took 28.17 us there and 177.79 us at path
// A's (N = 10^6, G = 1024), index_add_ 49.85 and 184.65 us in the same
// run (chip_smoke, same card): at A both are bound by ~1.2e7 scattered L2
// atomics (2.7 points an occupied cell leave little to merge), and the
// int64 scratch grid (8 bytes a cell, zeroed by the caller, read once
// more by to_float) costs K2 most of its lead.
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
// touching memory outside the grid.  N < 2^31 for the splat's scale.
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

constexpr int kBoundBlocks = 256;     // grid of abs_bound (grid-stride)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kFiniteBits = 0x7f800000u;   // +inf; NaNs lie above

// The splat's fixed-point exponent s (scale 2^s) from m's bits and N: the
// largest s with 2^s < 2^60 / (N m); 0 for m = 0 or non-finite.
__device__ __forceinline__ int fixed_shift(unsigned mbits, long long n) {
  if (mbits == 0u || mbits >= kFiniteBits) return 0;
  const double m = static_cast<double>(__uint_as_float(mbits));
  int e;
  const double r = frexp(0x1p60 / (static_cast<double>(n) * m), &e);
  return r > 0.5 ? e - 1 : e - 2;            // q = r 2^e, r in [0.5, 1)
}

// m = max_p max_c |v_pc| * S(f_p) as float bits into *mbits (zeroed).
__global__ void __launch_bounds__(kThreads)
abs_bound_kernel(const float* __restrict__ f, const float* __restrict__ vals,
                 long long n, int c, unsigned* __restrict__ mbits) {
  __shared__ unsigned red[kThreads / 32];
  unsigned best = 0u;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < n; p += static_cast<long long>(gridDim.x) * kThreads) {
    const float2 off = reinterpret_cast<const float2*>(f)[p];
    unsigned vbits = 0u;                     // max_c |v| as bits
    for (int ch = 0; ch < c; ++ch) {
      vbits = max(vbits, __float_as_uint(vals[p * c + ch]) & 0x7fffffffu);
    }
    const float sx = __fadd_rn(fabsf(__fsub_rn(1.0f, off.x)), fabsf(off.x));
    const float sy = __fadd_rn(fabsf(__fsub_rn(1.0f, off.y)), fabsf(off.y));
    // S >= 1, so a NaN or inf in vals or f leaves r NaN or inf
    const float r = __fmul_rn(__uint_as_float(vbits), __fmul_rn(sx, sy));
    best = max(best, __float_as_uint(r) & 0x7fffffffu);
  }
  best = __reduce_max_sync(kFull, best);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) best = max(best, red[w]);
    atomicMax(mbits, best);
  }
}

__device__ __forceinline__ long long to_fixed(float w, float v,
                                              double scale) {
  return __double2ll_rn(__dmul_rn(static_cast<double>(__fmul_rn(w, v)),
                                  scale));
}

// Sums q[0..3] over the lanes in `peers` (the lanes holding this lane's
// key) into the group's lowest lane, by a tree over the ranks in the group
// (Westphal, "Voting and shuffling to optimize atomic operations", NVIDIA
// developer blog, 2015); every lane of the warp calls it.
__device__ __forceinline__ void group_sum(unsigned peers, long long q[4]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);            // 1 + the next peer's lane
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long t = __shfl_sync(kFull, q[k], (next - 1) & 31);
      if (next) q[k] += t;
    }
    above &= __ballot_sync(kFull, (rank & 1) == 0);   // odd ranks are done
    rank >>= 1;
  }
}

// The splat proper: one thread per point, the warp's points that share a
// cell summed first.  acc (c, g, g) int64 zeroed; *atomics (or nullptr)
// counts the 64-bit atomics issued.
__global__ void __launch_bounds__(kThreads)
cic_splat_kernel(const int* __restrict__ i0, const float* __restrict__ f,
                 const float* __restrict__ vals, long long n, int c, int g,
                 const unsigned* __restrict__ mbits,
                 unsigned long long* __restrict__ acc,
                 unsigned long long* __restrict__ atomics) {
  // every lane stays to the end: the group sums shuffle over the warp
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  Corners k{};
  if (p < n) {
    const int2 cell = reinterpret_cast<const int2*>(i0)[p];
    const float2 off = reinterpret_cast<const float2*>(f)[p];
    k = corners(cell.x, cell.y, off.x, off.y, g);
  }
  const bool live = p < n && k.ok;
  const unsigned peers = __match_any_sync(kFull, live ? k.base : -1LL);
  const bool leader = live && (threadIdx.x & 31) == __ffs(peers) - 1;
  const double scale = ldexp(1.0, fixed_shift(*mbits, n));
  const long long gg = static_cast<long long>(g) * g;
  const long long offs[4] = {0, 1, g, g + 1};
  unsigned issued = 0u;
  for (int ch = 0; ch < c; ++ch) {
    const float v = live ? vals[p * c + ch] : 0.0f;
    long long q[4] = {to_fixed(k.w00, v, scale), to_fixed(k.w01, v, scale),
                      to_fixed(k.w10, v, scale), to_fixed(k.w11, v, scale)};
    group_sum(peers, q);
    if (leader) {
      unsigned long long* o = acc + ch * gg + k.base;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (q[t] != 0) {
          atomicAdd(o + offs[t], static_cast<unsigned long long>(q[t]));
          ++issued;
        }
      }
    }
  }
  if (atomics != nullptr) {
    issued = __reduce_add_sync(kFull, issued);
    if ((threadIdx.x & 31) == 0 && issued) {
      atomicAdd(atomics, static_cast<unsigned long long>(issued));
    }
  }
}

// out[k] = fl32(fl64(acc[k]) * 2^-s); all NaN for a non-finite bound.
__global__ void __launch_bounds__(kThreads)
fixed_to_float_kernel(const long long* __restrict__ acc, long long cells,
                      const unsigned* __restrict__ mbits, long long n,
                      float* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (k >= cells) return;
  const unsigned bits = *mbits;
  if (bits >= kFiniteBits) {
    out[k] = __int_as_float(0x7fffffff);
    return;
  }
  const double inv = ldexp(1.0, -fixed_shift(bits, n));
  out[k] = __double2float_rn(__dmul_rn(__ll2double_rn(acc[k]), inv));
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

// i0 (n, 2) int32 and f (n, 2) fp32, 8-byte aligned; vals (n, c) fp32, all
// row-major; acc (c * g * g + 1) int64 zeroed by the caller (the grid in
// fixed point, then the bound's slot); out (c, g, g) fp32; atomics a
// zeroed uint64 counter of the 64-bit atomics, or null.  Launches three
// kernels on `stream` and returns cudaGetLastError() after each (0 =
// launched).
extern "C" int cic_splat_f32(const void* i0, const void* f, const void* vals,
                             long long n, long long c, long long g,
                             void* acc, void* out, void* atomics,
                             void* stream) {
  if (n <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = c * g * g;
  unsigned long long* a = static_cast<unsigned long long*>(acc);
  unsigned* mbits = reinterpret_cast<unsigned*>(a + cells);
  const long long nb = static_cast<long long>(blocks_for(n));
  abs_bound_kernel<<<static_cast<unsigned int>(
                         nb < kBoundBlocks ? nb : kBoundBlocks),
                     kThreads, 0, s>>>(static_cast<const float*>(f),
                                       static_cast<const float*>(vals), n,
                                       static_cast<int>(c), mbits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cic_splat_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int*>(i0), static_cast<const float*>(f),
      static_cast<const float*>(vals), n, static_cast<int>(c),
      static_cast<int>(g), mbits, a,
      static_cast<unsigned long long*>(atomics));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fixed_to_float_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
      reinterpret_cast<const long long*>(a), cells, mbits, n,
      static_cast<float*>(out));
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
