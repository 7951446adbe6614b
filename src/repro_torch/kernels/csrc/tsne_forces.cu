// Fused exact tSNE gradient in two passes, never storing an N x N matrix:
//
//   K5a tsne_z:      Z = sum_{i != j, both < n_valid} 1 / (1 + |y_i - y_j|^2)
//   K5b tsne_forces: F_i = 4 sum_j (exag P_ij - num_ij / Z) num_ij (y_i - y_j)
//                    and the KL partials [sum pe log pe, sum pe log num]
//                    over the pairs with pe = exag P_ij > 0,
//
// with P_ij = 1/2 (w_i pc(j|i) + w_j pc(i|j)),
// pc(j|i) = exp(-beta_i |x_i - x_j|^2 - shift_i) / zp_i, recomputed on the
// fly from per-point stats (N, 4) = [beta, shift, zp, w].  Rows at or past
// n_valid (padding: w = 0, zp = 1) take part in no pair.
//
// Replaces: repro/kernels/tsne_forces.py:_z_kernel and _force_kernel (the
// Pallas TPU kernels behind tsne_z / tsne_forces).  Those walked a
// sequential (N/B)^2 grid of tiles on one core, carried Z, the forces and
// the KL sums in revisited output blocks, and ran the distance and force
// contractions as MXU matmuls.  None of that carries over: blocks run in
// parallel here, and with Dh = 8 and 2 output dims a pair is ~50 flops and
// 3-5 special-function ops, far too thin for tensor cores.
//
// K5b's design: a block of kRows threads owns kRows rows i (one row per
// thread, its x_i, y_i and stats in registers) and walks one of `splits`
// column ranges in tiles of kTile columns staged in shared memory (x_j,
// y_j and [-beta_j log2 e, -shift_j log2 e, w_j / (2 zp_j)]); every lane
// of a warp reads the same column, so the shared loads are broadcasts.
// The grid is (row tiles, splits): splitting the columns gives the card
// ~8 blocks per SM at the main path's N = 46k, where one split would
// leave 362 blocks for 132 SMs.
// Each thread sums a tile in fp32 registers and adds the tile's sum into
// fp64 accumulators; the per-(block, split) partial forces and the
// per-block KL partials go to fp64 scratch, and a second small kernel
// sums them in a fixed order.  No float atomics: Z, the forces and the KL
// partials are identical from run to run.
//
// K5a's redesign (PERF.md keeps its times): Z is symmetric, so the grid
// walks only the tile pairs (a, b) with b >= a of 512-row tiles, one
// block each, numbered along the triangle (the blocks are alike, so the
// load stays balanced): an off-diagonal tile adds twice its fp64 partial
// (an exact doubling), a diagonal tile its j != i pairs once.  At path
// E's N that halves the reciprocals, 2.15e9 -> 1.07e9.  A thread owns 4
// rows, so one broadcast shared load of y_j (a float2 at dims 2) serves 4
// pairs; interior tiles take no per-pair test, the diagonal and padded
// ones 32-bit tile-local tests (as K5b's step 1); 1 / (1 + d^2) is
// rcp.approx.ftz (K5b's step 2).  Each row sums 128 columns in fp32, then
// into fp64; the per-tile-pair partials are summed in a fixed order, so
// two calls give equal bits.  The first form ran every ordered
// pair with two 64-bit index tests and the IEEE reciprocal: 2.78 ms at
// path E; this one takes 0.33 ms against a 0.26 ms bound, both on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6).
//
// Distances: the direct difference sum_d (a_d - b_d)^2, not the
// reference's Gram identity max(|a|^2 - 2 a.b + |b|^2, 0), which loses
// the small distances of near neighbours to cancellation.
//
// K5b's redesign, four steps (PERF.md keeps each step's time):
//   1. Per-tile masks.  A tile that holds no diagonal pair, no padded
//      column and no padded row takes no per-pair test; the others take
//      32-bit tile-local tests (jj != diag, jj < valid, row_ok) in place
//      of the 64-bit index compares every pair paid before.
//   2. 1/(1 + d^2) by rcp.approx.ftz.f32, within 1 ulp (PTX ISA), in
//      place of the IEEE __frcp_rn sequence.
//   3. Whole-warp exp skip, 32 columns at a time.  The exponents are
//      formed in base 2, e = -beta log2(e) d^2 - shift log2(e), and 2^e by
//      ex2.approx.ftz (what __expf runs), which returns +0 for e < -126:
//      2^e is subnormal there, as exp is below ln 2^-126 = -87.3365, and
//      XLA:CPU and the TPU flush it to zero too.  A first small kernel
//      stores, for every group of 32 rows, the box of their x and the
//      largest -beta log2 e and -shift log2 e among them.  Before each
//      group of 32 columns a warp takes the least squared distance the
//      kernel can compute between its rows' box and the columns' box (the
//      per-dim gaps rounded as x_i - x_j rounds, summed by the same fma
//      chain, so never above any pair's d2x: rounding is monotone); if
//      with it every lane's own exponent and the columns' largest
//      exponent fall below -126, every 2^e of the 32 x 32 pairs is +0 and
//      the warp skips both exps and the distances in x, taking p = 0:
//      exactly the value the exps would give, so the skip never drops a
//      normal-range P and changes no bit (tests/test_torch_cuda_kernels.py
//      builds the kernel without it and compares).  A group with a NaN,
//      beta < 0 or a non-finite w / (2 zp) never skips.  A first form
//      voted per column on the exact exponents and skipped only the exps;
//      it cost more than it saved (PERF.md).  The logs are taken where
//      pe > 0, as before.
//   4. A locality order of the rows (tsne_forces.locality_order, a
//      Morton order of x, applied by tsne_step_fused on every call), so
//      that a warp's 32 rows are near each other in x and step 3 fires.
// Steps 1 and 3 can be compiled out (-DSNS_K5B_NO_TILE_MASKS,
// -DSNS_K5B_NO_EXP_SKIP): neither changes a bit, and the card tests and
// chip_k5b_steps.py build the kernel without them to show it.  The
// package defines neither.
//
// Bound: operations, not bytes (the inputs are N * (Dh + dims + 4) * 4
// bytes, a few MB).  Per valid pair K5b does 3 Dh + 5 dims + 11 fp32
// flops and 1 reciprocal, 2 exps where an exponent reaches -126, and 2
// logs and 4 flops more where P > 0 (the same pairs); K5a does 3 dims + 1
// flops and 1 reciprocal per unordered pair.  On an H100 the
// special-function units deliver 16 results per clock per SM (CUDA C
// Programming Guide, compute capability 9.0), the fp32 units 67 TFLOP/s.
// At path E's shapes (N = 46 348, Dh = 8, dims = 2; 10.0 % of the pairs
// reach -126) that bounds K5a at 0.26 ms counting each unordered pair's
// reciprocal once (0.51 ms over every ordered pair) and K5b at 0.72 ms
// counting the distances in x and the exps only where needed (1.46 ms
// counting every distance in x).
// K5b measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6),
// rows in the caller's order / the locality order: 7.16 / 6.28 ms before
// steps 1-3, 6.44 / 5.71 with step 1, 5.15 / 4.38 with steps 1-2,
// 5.67 / 2.78 with all three (the kernel before them: 8.49 ms).  Step 3's
// first form, a per-column vote that skipped only the exps, made it slower
// (4.92 ms in the locality order): K5b is bound by its issue rate (~40
// instructions a pair against 3 special-function results), so only
// skipping the distances in x pays.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 128;   // rows per block = threads per block
constexpr int kTile = 128;   // columns staged in shared memory per step
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2E = 1.4426950408889634f;
// 2^t < 2^-126 is subnormal in fp32: ex2.approx.ftz flushes it to +0, as
// XLA:CPU and the TPU flush exp(t ln 2) below ln 2^-126 = -87.3365
constexpr float kExpFloor = -126.0f;
#ifdef SNS_K5B_NO_TILE_MASKS
constexpr bool kAlwaysMasked = true;
#else
constexpr bool kAlwaysMasked = false;
#endif

// Sum of v over the block, in a fixed order; the result is valid in
// thread 0.  Every thread of the block must call it.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      total += red[w];
    }
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ long long split_lo(long long chunk) {
  return static_cast<long long>(blockIdx.y) * chunk;
}

// 2^t by the special-function unit, its subnormal results flushed to +0:
// exactly 0 for t < kExpFloor.
__device__ __forceinline__ float ex2_ftz(float t) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r;
}

// 1/x within 1 ulp (PTX ISA, rcp.approx.f32); x = 1 + d^2 >= 1 here, so
// flushing subnormals changes nothing.
__device__ __forceinline__ float rcp_fast(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// K5a: tile pairs (a, b), b >= a, of kZTile rows each; a block of
// kZThreads threads takes one, each thread kZRows rows of tile a
// (threadIdx.x + q * kZThreads) against every column of tile b, staged in
// shared memory.  k = blockIdx.x walks the triangle column by column:
// b(b + 1) / 2 <= k < (b + 1)(b + 2) / 2, a = k - b(b + 1) / 2.
constexpr int kZThreads = 128;
constexpr int kZRows = 4;                      // rows a thread
constexpr int kZTile = kZThreads * kZRows;     // 512 rows, 512 columns
constexpr int kZSub = 128;                     // columns an fp32 partial

template <int DY> struct YVec;
template <> struct YVec<2> { using T = float2; };
template <> struct YVec<4> { using T = float4; };

__device__ __forceinline__ float one_plus_d2(float2 a, float2 b) {
  const float dx = a.x - b.x, dy = a.y - b.y;
  return fmaf(dx, dx, fmaf(dy, dy, 1.0f));
}

__device__ __forceinline__ float one_plus_d2(float4 a, float4 b) {
  const float d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z,
              d3 = a.w - b.w;
  return fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, fmaf(d3, d3, 1.0f))));
}

template <int DY>
__global__ void __launch_bounds__(kZThreads)
tsne_z_pairs(const float* __restrict__ y, long long nv,
             double* __restrict__ zpart) {
  using V = typename YVec<DY>::T;
  __shared__ V sy[kZTile];
  __shared__ double red[kZThreads / 32];
  const long long k = blockIdx.x;
  long long b = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while (b * (b + 1) / 2 > k) --b;
  while ((b + 1) * (b + 2) / 2 <= k) ++b;
  const long long a = k - b * (b + 1) / 2;
  const V* yv = reinterpret_cast<const V*>(y);
  const long long r0 = a * kZTile, c0 = b * kZTile;
  const int rows = static_cast<int>(nv - r0 < kZTile ? nv - r0 : kZTile);
  const int cols = static_cast<int>(nv - c0 < kZTile ? nv - c0 : kZTile);
  for (int t = threadIdx.x; t < cols; t += kZThreads) sy[t] = yv[c0 + t];
  V yi[kZRows];
#pragma unroll
  for (int q = 0; q < kZRows; ++q) {
    const int ri = threadIdx.x + q * kZThreads;
    yi[q] = ri < rows ? yv[r0 + ri] : V{};
  }
  __syncthreads();
  // a < b: tile a lies wholly below tile b, so only tile b can hold
  // padding; a == b holds the diagonal
  const bool diag = a == b;
  double acc = 0.0;
  if (!diag && cols == kZTile) {
    // interior: no per-pair test
    for (int j0 = 0; j0 < kZTile; j0 += kZSub) {
      float part[kZRows] = {};
#pragma unroll 4
      for (int jj = j0; jj < j0 + kZSub; ++jj) {
        const V yj = sy[jj];
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          part[q] += rcp_fast(one_plus_d2(yi[q], yj));
        }
      }
#pragma unroll
      for (int q = 0; q < kZRows; ++q) acc += part[q];
    }
  } else {
    // tile-local 32-bit tests: j != i on the diagonal, columns past nv
    // not visited, rows past nv dropped
    int self[kZRows];
#pragma unroll
    for (int q = 0; q < kZRows; ++q) {
      self[q] = diag ? static_cast<int>(threadIdx.x) + q * kZThreads : -1;
    }
    for (int j0 = 0; j0 < cols; j0 += kZSub) {
      const int j1 = j0 + kZSub < cols ? j0 + kZSub : cols;
      float part[kZRows] = {};
      for (int jj = j0; jj < j1; ++jj) {
        const V yj = sy[jj];
#pragma unroll
        for (int q = 0; q < kZRows; ++q) {
          const float r = rcp_fast(one_plus_d2(yi[q], yj));
          part[q] += jj != self[q] ? r : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kZRows; ++q) {
        if (static_cast<int>(threadIdx.x) + q * kZThreads < rows) {
          acc += part[q];
        }
      }
    }
  }
  const double total = block_sum(acc, red);
  // an off-diagonal tile stands for its mirror too: the doubling is exact
  if (threadIdx.x == 0) zpart[k] = diag ? total : 2.0 * total;
}

#ifdef SNS_K5B_NO_EXP_SKIP
constexpr bool kExpSkip = false;
#else
constexpr bool kExpSkip = true;
#endif

// A group of 32 consecutive rows, one record of kBoundStride floats: the
// box of the valid rows' x (lo[DH], hi[DH]; +inf, -inf with none), then
// nb = max -beta log2 e and ns = max -shift log2 e over them (-inf with
// none; ns NaN if a row has a NaN in x or its stats, a non-finite
// w / (2 zp) or beta < 0: such a group never skips).
template <int DH>
constexpr int kBoundStride = 2 * DH + 4;

// One warp a group: the group bounds of rows [32 g, 32 g + 32).
template <int DH>
__global__ void __launch_bounds__(kRows)
group_bounds_kernel(const float* __restrict__ x,
                    const float* __restrict__ stats, long long n,
                    long long n_valid, long long groups,
                    float* __restrict__ gb) {
  const long long g = static_cast<long long>(blockIdx.x) * (kRows / 32) +
                      (threadIdx.x >> 5);
  if (g >= groups) return;                      // whole warps return
  const int lane = threadIdx.x & 31;
  const long long i = g * 32 + lane;
  const bool ok = i < n_valid && i < n;
  float lo[DH], hi[DH];
  bool bad = false;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float v = ok ? x[i * DH + d] : 0.0f;
    bad |= ok && isnan(v);
    lo[d] = ok ? v : CUDART_INF_F;
    hi[d] = ok ? v : -CUDART_INF_F;
  }
  float nb = -CUDART_INF_F, ns = -CUDART_INF_F;
  if (ok) {
    const float4 st = reinterpret_cast<const float4*>(stats)[i];
    nb = -st.x * kLog2E;
    ns = -st.y * kLog2E;
    const float c = 0.5f * st.w / st.z;
    bad |= !(nb <= 0.0f) || isnan(ns) || !isfinite(c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
    }
    nb = fmaxf(nb, __shfl_xor_sync(kFull, nb, off));
    ns = fmaxf(ns, __shfl_xor_sync(kFull, ns, off));
  }
  bad = __any_sync(kFull, bad);
  if (lane == 0) {
    float* out = gb + g * kBoundStride<DH>;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      out[d] = lo[d];
      out[DH + d] = hi[d];
    }
    out[2 * DH] = nb;
    out[2 * DH + 1] = bad ? CUDART_NAN_F : ns;
  }
}

// The least fp32 squared distance the kernel can compute between a row of
// box a and a column of box b: per dim the gap between the boxes, rounded
// as the kernel rounds x_i - x_j (monotone), summed by the same fma chain
// in the same order, so never above the kernel's d2x for such a pair.
template <int DH>
__device__ __forceinline__ float box_d2(const float* __restrict__ a,
                                        const float* __restrict__ b) {
  float d2 = 0.0f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float gap = fmaxf(fmaxf(b[d] - a[DH + d], a[d] - b[DH + d]), 0.0f);
    d2 = fmaf(gap, gap, d2);
  }
  return d2;
}

// Columns [j0, j1) of the staged tile against this thread's row.
// kMasked: the tile holds the diagonal, padded columns or padded rows,
// and each pair takes the 32-bit test ok = row_ok && jj != diag && jj <
// valid; other tiles take none.  kAttract: p from both exps (base 2:
// beta and shift prescaled by log2 e in nb, ns and sc); without it p = 0,
// the value both 2^e take when every exponent is below kExpFloor, and the
// distances in x are not needed.
template <int DH, int DY, bool kMasked, bool kAttract>
__device__ __forceinline__ void force_cols(
    const float (&xi)[DH], const float (&yi)[DY], float nb_i, float ns_i,
    float c_i, const float4* __restrict__ sx, const float* __restrict__ sy,
    const float4* __restrict__ sc, int j0, int j1, bool row_ok, int diag,
    int valid, float exag, float inv_z, float (&f)[DY], float& a, float& b) {
  constexpr int kQ = DH / 4;
#pragma unroll 2
  for (int jj = j0; jj < j1; ++jj) {
    float dy[DY];
    float d2y = 0.0f;
#pragma unroll
    for (int d = 0; d < DY; ++d) {
      dy[d] = yi[d] - sy[jj * DY + d];
      d2y = fmaf(dy[d], dy[d], d2y);
    }
    float p = 0.0f;
    if constexpr (kAttract) {
      float d2x = 0.0f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 xj = sx[jj * kQ + q];
        const float t0 = xi[4 * q] - xj.x;
        const float t1 = xi[4 * q + 1] - xj.y;
        const float t2 = xi[4 * q + 2] - xj.z;
        const float t3 = xi[4 * q + 3] - xj.w;
        d2x = fmaf(t0, t0, d2x);
        d2x = fmaf(t1, t1, d2x);
        d2x = fmaf(t2, t2, d2x);
        d2x = fmaf(t3, t3, d2x);
      }
      const float4 sj = sc[jj];
      p = c_i * ex2_ftz(fmaf(nb_i, d2x, ns_i)) +
          sj.z * ex2_ftz(fmaf(sj.x, d2x, sj.y));
    }
    float num = rcp_fast(1.0f + d2y);
    if (kMasked && !(row_ok && jj != diag && jj < valid)) {
      p = 0.0f;
      num = 0.0f;
    }
    const float pe = exag * p;
    const float pq = (pe - num * inv_z) * num;
#pragma unroll
    for (int d = 0; d < DY; ++d) f[d] = fmaf(pq, dy[d], f[d]);
    if (kAttract && pe > 0.0f) {
      a = fmaf(pe, __logf(pe), a);
      b = fmaf(pe, __logf(fmaxf(num, 1e-37f)), b);
    }
  }
}

template <int DH, int DY>
__global__ void __launch_bounds__(kRows)
tsne_force_partial(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ stats,
                   const float* __restrict__ gb, long long n,
                   long long n_valid, const float* __restrict__ z,
                   float exag, long long chunk, double* __restrict__ fpart,
                   double* __restrict__ klpart) {
  constexpr int kQ = DH / 4;                     // float4s per x row
  constexpr int kS = kBoundStride<DH>;
  constexpr int kGroups = kTile / 32;            // column groups a tile
  __shared__ float4 sx[kTile * kQ];
  __shared__ float sy[kTile * DY];
  // -beta log2 e, -shift log2 e, w / (2 zp)
  __shared__ float4 sc[kTile];
  __shared__ float sgb[(kRows / 32 + kGroups) * kS];   // rows', columns'
  __shared__ double red[kRows / 32];

  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long i = r0 + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const bool have_row = i < n;
  const bool row_ok = i < n_valid;
  float xi[DH];
  float yi[DY];
#pragma unroll
  for (int d = 0; d < DH; ++d) xi[d] = have_row ? x[i * DH + d] : 0.0f;
#pragma unroll
  for (int d = 0; d < DY; ++d) yi[d] = have_row ? y[i * DY + d] : 0.0f;
  float nb_i = 0.0f, ns_i = 0.0f, c_i = 0.0f;
  if (have_row) {
    nb_i = -stats[4 * i] * kLog2E;
    ns_i = -stats[4 * i + 1] * kLog2E;
    c_i = 0.5f * stats[4 * i + 3] / stats[4 * i + 2];
  }
  const float inv_z = 1.0f / z[0];
  const bool rows_full = r0 + kRows <= n_valid;
  const long long groups = (n + 31) / 32;
  float* rgb = sgb + warp * kS;                  // this warp's rows' bound
  float* cgb = sgb + (kRows / 32) * kS;          // the tile's columns'
  for (int t = threadIdx.x; t < (kRows / 32) * kS; t += kRows) {
    const long long g = r0 / 32 + t / kS;
    sgb[t] = g < groups ? gb[g * kS + t % kS] : CUDART_NAN_F;
  }

  double f_acc[DY];
#pragma unroll
  for (int d = 0; d < DY; ++d) f_acc[d] = 0.0;
  double a_acc = 0.0, b_acc = 0.0;
  const long long j_lo = split_lo(chunk);
  const long long j_hi = j_lo + chunk < n ? j_lo + chunk : n;
  for (long long jt = j_lo; jt < j_hi; jt += kTile) {
    const int cnt = static_cast<int>(j_hi - jt < kTile ? j_hi - jt : kTile);
    __syncthreads();                 // every lane is done with the last tile
    const float4* xt = reinterpret_cast<const float4*>(x + jt * DH);
    for (int t = threadIdx.x; t < cnt * kQ; t += kRows) sx[t] = xt[t];
    for (int t = threadIdx.x; t < cnt * DY; t += kRows) {
      sy[t] = y[jt * DY + t];
    }
    for (int t = threadIdx.x; t < cnt; t += kRows) {
      const float4 s = reinterpret_cast<const float4*>(stats)[jt + t];
      sc[t] = make_float4(-s.x * kLog2E, -s.y * kLog2E, 0.5f * s.w / s.z,
                          0.0f);
    }
    for (int t = threadIdx.x; t < kGroups * kS; t += kRows) {
      const long long g = jt / 32 + t / kS;
      cgb[t] = g < groups ? gb[g * kS + t % kS] : CUDART_NAN_F;
    }
    __syncthreads();
    // 32-bit tile-local tests only where the tile needs them
    const long long dj = i - jt;
    const int diag = dj >= 0 && dj < cnt ? static_cast<int>(dj) : -1;
    const long long left = n_valid - jt;
    const int valid = left < 0 ? 0 : (left < cnt ? static_cast<int>(left)
                                                 : cnt);
    const bool masked = kAlwaysMasked || !rows_full || valid < cnt ||
                        (r0 < jt + cnt && jt < r0 + kRows);
    float f[DY];
#pragma unroll
    for (int d = 0; d < DY; ++d) f[d] = 0.0f;
    float a = 0.0f, b = 0.0f;
    for (int g = 0; g * 32 < cnt; ++g) {
      const int j0 = g * 32;
      const int j1 = j0 + 32 < cnt ? j0 + 32 : cnt;
      // skip the attraction of these 32 columns when a bound puts every
      // exponent of the warp's rows against them below kExpFloor
      bool attract = true;
      if (kExpSkip) {
        const float* cb = cgb + g * kS;
        const float d2 = box_d2<DH>(rgb, cb);
        const bool col_need =
            !(fmaf(cb[2 * DH], d2, cb[2 * DH + 1]) < kExpFloor);
        const bool row_need =
            !(rgb[2 * DH + 1] == rgb[2 * DH + 1]) ||        // NaN: poisoned
            (row_ok && !(fmaf(nb_i, d2, ns_i) < kExpFloor));
        attract = col_need || __any_sync(kFull, row_need);
      }
#define SNS_COLS(MASKED, ATTRACT)                                          \
  force_cols<DH, DY, MASKED, ATTRACT>(xi, yi, nb_i, ns_i, c_i, sx, sy, sc,  \
                                      j0, j1, row_ok, diag, valid, exag,     \
                                      inv_z, f, a, b)
      if (masked) {
        if (attract) {
          SNS_COLS(true, true);
        } else {
          SNS_COLS(true, false);
        }
      } else if (attract) {
        SNS_COLS(false, true);
      } else {
        SNS_COLS(false, false);
      }
#undef SNS_COLS
    }
#pragma unroll
    for (int d = 0; d < DY; ++d) f_acc[d] += f[d];
    a_acc += a;
    b_acc += b;
  }
  if (have_row) {
#pragma unroll
    for (int d = 0; d < DY; ++d) {
      fpart[(static_cast<long long>(blockIdx.y) * n + i) * DY + d] =
          f_acc[d];
    }
  }
  const double ta = block_sum(a_acc, red);
  const double tb = block_sum(b_acc, red);
  if (threadIdx.x == 0) {
    const long long slot =
        static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    klpart[2 * slot] = ta;
    klpart[2 * slot + 1] = tb;
  }
}

// out[k] = 4 * sum over the splits of fpart[s, k], k over n * dims.
__global__ void tsne_force_finish(const double* __restrict__ fpart,
                                  long long m, int splits,
                                  float* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= m) return;
  double s = 0.0;
  for (int t = 0; t < splits; ++t) s += fpart[t * m + k];
  out[k] = static_cast<float>(4.0 * s);
}

// Column sums of part (rows, width) in a fixed order, by one block, to
// out_d (fp64) and / or out_f (fp32), whichever is given.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const double* __restrict__ part, long long rows, int width,
                double* __restrict__ out_d, float* __restrict__ out_f) {
  __shared__ double red[kReduceThreads / 32];
  for (int c = 0; c < width; ++c) {
    double s = 0.0;
    for (long long r = threadIdx.x; r < rows; r += kReduceThreads) {
      s += part[r * width + c];
    }
    const double total = block_sum(s, red);
    if (threadIdx.x == 0) {
      if (out_d != nullptr) out_d[c] = total;
      if (out_f != nullptr) out_f[c] = static_cast<float>(total);
    }
  }
}

long long row_tiles(long long n) { return (n + kRows - 1) / kRows; }

long long split_chunk(long long n, long long splits) {
  const long long per = (n + splits - 1) / splits;
  return (per + kTile - 1) / kTile * kTile;
}

long long z_tiles(long long nv) { return (nv + kZTile - 1) / kZTile; }

long long z_tile_pairs(long long tiles) { return tiles * (tiles + 1) / 2; }

template <int DY>
cudaError_t launch_z(const float* y, long long nv, long long pairs,
                     double* zpart, float* z, cudaStream_t stream) {
  tsne_z_pairs<DY><<<static_cast<unsigned int>(pairs), kZThreads, 0,
                     stream>>>(y, nv, zpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<1, kReduceThreads, 0, stream>>>(zpart, pairs, 1,
                                                    nullptr, z);
  return cudaGetLastError();
}

long long bound_groups(long long n) { return (n + 31) / 32; }

template <int DH, int DY>
cudaError_t launch_forces(const float* x, const float* y, const float* stats,
                          long long n, long long n_valid, const float* z,
                          float exag, long long splits, float* gb,
                          double* fpart, double* klpart, float* forces,
                          double* kl, cudaStream_t stream) {
  const long long groups = bound_groups(n);
  group_bounds_kernel<DH><<<static_cast<unsigned int>(
                                (groups + kRows / 32 - 1) / (kRows / 32)),
                            kRows, 0, stream>>>(x, stats, n, n_valid, groups,
                                                gb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(row_tiles(n)),
                  static_cast<unsigned int>(splits));
  tsne_force_partial<DH, DY><<<grid, kRows, 0, stream>>>(
      x, y, stats, gb, n, n_valid, z, exag, split_chunk(n, splits), fpart,
      klpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long m = n * DY;
  tsne_force_finish<<<static_cast<unsigned int>((m + 255) / 256), 256, 0,
                      stream>>>(fpart, m, static_cast<int>(splits), forces);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<1, kReduceThreads, 0, stream>>>(
      klpart, row_tiles(n) * splits, 2, kl, nullptr);
  return cudaGetLastError();
}

}  // namespace

// Rows per block: the scratch holds row_tiles(n) * splits partials, with
// row_tiles(n) = ceil(n / tsne_block_rows()).
extern "C" int tsne_block_rows() { return kRows; }

// Floats of tsne_forces_f32's group-bound scratch for n rows of width dh
// (below 2^31 for any n an exact N x N pass can take).
extern "C" int tsne_bound_floats(long long n, long long dh) {
  return static_cast<int>(bound_groups(n) * (2 * dh + 4));
}

// Partials of tsne_z_f32's scratch: the tile pairs (a, b), b >= a, of
// the first min(n, n_valid) rows.
extern "C" long long tsne_z_partials(long long n, long long n_valid) {
  const long long nv = n_valid < n ? n_valid : n;
  return nv > 0 ? z_tile_pairs(z_tiles(nv)) : 0;
}

// y (n, dy) fp32 with dy in {2, 4}, aligned to dy floats; zpart
// (tsne_z_partials(n, n_valid)) fp64 scratch; z (1) fp32 out, left as it
// is when no row is valid.  Returns cudaGetLastError() after each launch
// (0 = launched), or cudaErrorInvalidValue for an unsupported dy or more
// tile pairs than a grid holds.
extern "C" int tsne_z_f32(const void* y, long long n, long long dy,
                          long long n_valid, void* zpart, void* z,
                          void* stream) {
  const long long nv = n_valid < n ? n_valid : n;
  const long long pairs = tsne_z_partials(n, n_valid);
  if (pairs <= 0) return 0;
  if (pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* yy = static_cast<const float*>(y);
  double* zp = static_cast<double*>(zpart);
  float* zz = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dy) {
    case 2: return static_cast<int>(launch_z<2>(yy, nv, pairs, zp, zz, s));
    case 4: return static_cast<int>(launch_z<4>(yy, nv, pairs, zp, zz, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (n, dh) fp32 with dh in {8, 16, 32}, 16-byte aligned; y (n, dy) with
// dy in {2, 4}; stats (n, 4) fp32, 16-byte aligned; z (1) fp32 on the
// card; bounds (tsne_bound_floats(n, dh)) fp32, fpart (splits, n, dy) and
// klpart (row_tiles * splits, 2) fp64 scratch; forces (n, dy) fp32 and kl
// (2) fp64 out.
extern "C" int tsne_forces_f32(const void* x, long long dh, const void* y,
                               long long dy, const void* stats, long long n,
                               long long n_valid, const void* z, float exag,
                               long long splits, void* bounds, void* fpart,
                               void* klpart, void* forces, void* kl,
                               void* stream) {
  if (n <= 0 || splits <= 0) return 0;
  float* gb = static_cast<float*>(bounds);
  const float* xx = static_cast<const float*>(x);
  const float* yy = static_cast<const float*>(y);
  const float* st = static_cast<const float*>(stats);
  const float* zz = static_cast<const float*>(z);
  double* fp = static_cast<double*>(fpart);
  double* kp = static_cast<double*>(klpart);
  float* out = static_cast<float*>(forces);
  double* k = static_cast<double*>(kl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SNS_FORCES(DH, DY)                                                 \
  if (dh == DH && dy == DY)                                                \
    return static_cast<int>(launch_forces<DH, DY>(                         \
        xx, yy, st, n, n_valid, zz, exag, splits, gb, fp, kp, out, k, s));
  SNS_FORCES(8, 2)
  SNS_FORCES(16, 2)
  SNS_FORCES(32, 2)
  SNS_FORCES(8, 4)
  SNS_FORCES(16, 4)
  SNS_FORCES(32, 4)
#undef SNS_FORCES
  return static_cast<int>(cudaErrorInvalidValue);
}
