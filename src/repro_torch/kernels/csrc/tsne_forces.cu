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
// Design: a block of kRows threads owns kRows rows i (one row per thread,
// its x_i, y_i and stats in registers) and walks one of `splits` column
// ranges in tiles of kTile columns staged in shared memory (x_j, y_j and
// [beta_j, shift_j, w_j / (2 zp_j)]); every lane of a warp reads the same
// column, so the shared loads are broadcasts.  The grid is (row tiles,
// splits): splitting the columns gives the card ~8 blocks per SM at the
// main path's N = 46k, where one split would leave 362 blocks for 132 SMs.
// Each thread sums a tile in fp32 registers and adds the tile's sum into
// fp64 accumulators; the per-(block, split) partial forces and the
// per-block Z / KL partials go to fp64 scratch, and a second small kernel
// sums them in a fixed order.  No float atomics: Z, the forces and the KL
// partials are identical from run to run.
//
// Distances: the direct difference sum_d (a_d - b_d)^2, not the
// reference's Gram identity max(|a|^2 - 2 a.b + |b|^2, 0), which loses
// the small distances of near neighbours to cancellation.  The exps are
// __expf (ex2.approx of x log2 e): its error grows like |x| * 2^-23, the
// same order as the fp32 rounding of the argument -beta d^2 - shift
// itself.  1/(1 + d^2) is __frcp_rn (IEEE); the logs are __logf.
//
// Bound: operations, not bytes (the inputs are N * (Dh + dims + 4) * 4
// bytes, a few MB).  Per valid pair K5b does 3 Dh + 5 dims + 11 fp32
// flops, 2 exps and 1 reciprocal on the special-function units, and 2
// logs and 4 flops more where P > 0; K5a does 3 dims + 1 flops and 1
// reciprocal.  On an H100 the special-function units deliver 16 results
// per clock per SM (CUDA C Programming Guide, compute capability 9.0), so
// at path E's shapes (N = 46 348, Dh = 8, dims = 2, P > 0 on 10 % of the
// pairs) the SFU side bounds both: 0.51 ms for K5a and 1.64 ms for K5b.
// chip_smoke.py measured 2.78 ms and 8.50 ms (NVIDIA H100 80GB HBM3,
// 700 W), 5.4x and 5.2x the bound.  Not measured, inferred from the code:
// every pair pays 64-bit index compares for the masks and an IEEE
// reciprocal sequence, and a warp takes the log branch whenever one lane
// has P > 0, which on path E is nearly every step.  Masking per tile, an
// approximate reciprocal and a row order that groups neighbours are the
// next steps.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;   // rows per block = threads per block
constexpr int kTile = 128;   // columns staged in shared memory per step
constexpr int kReduceThreads = 256;

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

template <int DY>
__global__ void __launch_bounds__(kRows)
tsne_z_partial(const float* __restrict__ y, long long n, long long n_valid,
               long long chunk, double* __restrict__ zpart) {
  __shared__ float sy[kTile * DY];
  __shared__ double red[kRows / 32];
  const long long i = static_cast<long long>(blockIdx.x) * kRows +
                      threadIdx.x;
  const bool row_ok = i < n_valid;
  float yi[DY];
#pragma unroll
  for (int d = 0; d < DY; ++d) yi[d] = i < n ? y[i * DY + d] : 0.0f;
  const long long j_lo = split_lo(chunk);
  const long long j_hi = j_lo + chunk < n ? j_lo + chunk : n;
  double acc = 0.0;
  for (long long jt = j_lo; jt < j_hi; jt += kTile) {
    const int cnt = static_cast<int>(j_hi - jt < kTile ? j_hi - jt : kTile);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt * DY; t += kRows) {
      sy[t] = y[jt * DY + t];
    }
    __syncthreads();
    float part = 0.0f;
    for (int jj = 0; jj < cnt; ++jj) {
      const long long j = jt + jj;
      float d2 = 0.0f;
#pragma unroll
      for (int d = 0; d < DY; ++d) {
        const float df = yi[d] - sy[jj * DY + d];
        d2 = fmaf(df, df, d2);
      }
      const bool ok = row_ok && j != i && j < n_valid;
      part += ok ? __frcp_rn(1.0f + d2) : 0.0f;
    }
    acc += part;
  }
  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    zpart[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] =
        total;
  }
}

template <int DH, int DY>
__global__ void __launch_bounds__(kRows)
tsne_force_partial(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ stats, long long n,
                   long long n_valid, const float* __restrict__ z,
                   float exag, long long chunk, double* __restrict__ fpart,
                   double* __restrict__ klpart) {
  constexpr int kQ = DH / 4;                     // float4s per x row
  __shared__ float4 sx[kTile * kQ];
  __shared__ float sy[kTile * DY];
  __shared__ float4 ss[kTile];                   // beta, shift, w/(2 zp)
  __shared__ double red[kRows / 32];

  const long long i = static_cast<long long>(blockIdx.x) * kRows +
                      threadIdx.x;
  const bool have_row = i < n;
  const bool row_ok = i < n_valid;
  float xi[DH];
  float yi[DY];
#pragma unroll
  for (int d = 0; d < DH; ++d) xi[d] = have_row ? x[i * DH + d] : 0.0f;
#pragma unroll
  for (int d = 0; d < DY; ++d) yi[d] = have_row ? y[i * DY + d] : 0.0f;
  float beta_i = 0.0f, shift_i = 0.0f, c_i = 0.0f;
  if (have_row) {
    beta_i = stats[4 * i];
    shift_i = stats[4 * i + 1];
    c_i = 0.5f * stats[4 * i + 3] / stats[4 * i + 2];
  }
  const float inv_z = 1.0f / z[0];

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
      ss[t] = make_float4(s.x, s.y, 0.5f * s.w / s.z, 0.0f);
    }
    __syncthreads();
    float f[DY];
#pragma unroll
    for (int d = 0; d < DY; ++d) f[d] = 0.0f;
    float a = 0.0f, b = 0.0f;
    for (int jj = 0; jj < cnt; ++jj) {
      const long long j = jt + jj;
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
      float dy[DY];
      float d2y = 0.0f;
#pragma unroll
      for (int d = 0; d < DY; ++d) {
        dy[d] = yi[d] - sy[jj * DY + d];
        d2y = fmaf(dy[d], dy[d], d2y);
      }
      const float4 sj = ss[jj];
      const bool ok = row_ok && j != i && j < n_valid;
      float p = 0.0f, num = 0.0f;
      if (ok) {
        p = c_i * __expf(fmaf(-beta_i, d2x, -shift_i)) +
            sj.z * __expf(fmaf(-sj.x, d2x, -sj.y));
        num = __frcp_rn(1.0f + d2y);
      }
      const float pe = exag * p;
      const float pq = (pe - num * inv_z) * num;
#pragma unroll
      for (int d = 0; d < DY; ++d) f[d] = fmaf(pq, dy[d], f[d]);
      if (pe > 0.0f) {
        a = fmaf(pe, __logf(pe), a);
        b = fmaf(pe, __logf(fmaxf(num, 1e-37f)), b);
      }
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

template <int DY>
cudaError_t launch_z(const float* y, long long n, long long n_valid,
                     long long splits, double* zpart, float* z,
                     cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(row_tiles(n)),
                  static_cast<unsigned int>(splits));
  tsne_z_partial<DY><<<grid, kRows, 0, stream>>>(
      y, n, n_valid, split_chunk(n, splits), zpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<1, kReduceThreads, 0, stream>>>(
      zpart, row_tiles(n) * splits, 1, nullptr, z);
  return cudaGetLastError();
}

template <int DH, int DY>
cudaError_t launch_forces(const float* x, const float* y, const float* stats,
                          long long n, long long n_valid, const float* z,
                          float exag, long long splits, double* fpart,
                          double* klpart, float* forces, double* kl,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(row_tiles(n)),
                  static_cast<unsigned int>(splits));
  tsne_force_partial<DH, DY><<<grid, kRows, 0, stream>>>(
      x, y, stats, n, n_valid, z, exag, split_chunk(n, splits), fpart,
      klpart);
  cudaError_t err = cudaGetLastError();
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

// y (n, dy) fp32 with dy in {2, 4}; zpart (row_tiles * splits) fp64
// scratch; z (1) fp32 out.  Returns cudaGetLastError() after each launch
// (0 = launched), or cudaErrorInvalidValue for an unsupported dy.
extern "C" int tsne_z_f32(const void* y, long long n, long long dy,
                          long long n_valid, long long splits, void* zpart,
                          void* z, void* stream) {
  if (n <= 0 || splits <= 0) return 0;
  const float* yy = static_cast<const float*>(y);
  double* zp = static_cast<double*>(zpart);
  float* zz = static_cast<float*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dy) {
    case 2: return static_cast<int>(launch_z<2>(yy, n, n_valid, splits,
                                                zp, zz, s));
    case 4: return static_cast<int>(launch_z<4>(yy, n, n_valid, splits,
                                                zp, zz, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (n, dh) fp32 with dh in {8, 16, 32}, 16-byte aligned; y (n, dy) with
// dy in {2, 4}; stats (n, 4) fp32, 16-byte aligned; z (1) fp32 on the
// card; fpart (splits, n, dy) and klpart (row_tiles * splits, 2) fp64
// scratch; forces (n, dy) fp32 and kl (2) fp64 out.
extern "C" int tsne_forces_f32(const void* x, long long dh, const void* y,
                               long long dy, const void* stats, long long n,
                               long long n_valid, const void* z, float exag,
                               long long splits, void* fpart, void* klpart,
                               void* forces, void* kl, void* stream) {
  if (n <= 0 || splits <= 0) return 0;
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
        xx, yy, st, n, n_valid, zz, exag, splits, fp, kp, out, k, s));
  SNS_FORCES(8, 2)
  SNS_FORCES(16, 2)
  SNS_FORCES(32, 2)
  SNS_FORCES(8, 4)
  SNS_FORCES(16, 4)
  SNS_FORCES(32, 4)
#undef SNS_FORCES
  return static_cast<int>(cudaErrorInvalidValue);
}
