// Masked squared-distance tiles for the approximate kNN's candidate stage
// (K4 knn_dist_tiles): for T sorted tiles of B query rows, each scored
// against its own window of C = 3B candidate rows,
//
//   out[t, i, j] = max(|q|^2 + |c|^2 - 2 q.c, 0)     in fp32 (Gram form),
//   out[t, i, j] = +inf  where cid[t, j] < 0 or cid[t, j] == qid[t, i].
//
// Replaces: repro/kernels/knn_tile.py:_dist_kernel (the Pallas TPU kernel
// behind _distance_tiles_pallas).  There one grid step held a whole tile's
// (B, D) queries and (C, D) window in VMEM and ran the cross term q @ c^T on
// the matrix unit.  The contraction depth here is D = 8 (the cancer data's
// PCA colours), far below what a tensor-core instruction takes, so the
// product is plain fp32 FMAs in the kernel's own body.
//
// Design: one block per (tile, 128 candidate columns); one thread per
// column.  A thread keeps its candidate vector and |c|^2 in registers
// (DMAX is the smallest of 8/16/32/64 that holds D, zero-padded), the
// block stages its tile's query rows 32 at a time in shared memory
// (rows, |q|^2 and ids), and each thread walks the staged rows reading
// them as broadcasts, so every row's 128 outputs are one coalesced
// 512-byte store.  The sum |q|^2 + |c|^2 is rounded before 2 q.c is
// subtracted, as the plain version does (no FMA contraction there).
//
// Bound: memory.  The call must write T*B*C*4 bytes, three times what it
// reads (the windows are 3B rows of D floats per tile, the queries B):
// at B = 128, D = 8 a 1024-tile chunk writes 201 MB and reads 17 MB, while
// its 2*D*B*C*T = 805 MFLOP take 12 us at 67 TFLOP/s against 66 us of
// bytes at 3.35 TB/s.  chip_smoke.py measured 75.5 us for such a chunk on
// an H100 80GB HBM3 at 700 W: 1.15x the bound.  Writing the block at all
// is the cost: fusing the per-row top-k so that the (T, B, C) block never
// reaches device memory is the redesign that removes it (ROADMAP).
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // candidate columns per block, one per thread
constexpr int kRows = 32;   // query rows staged in shared memory at a time

template <int DMAX>
__global__ void __launch_bounds__(kCols)
knn_tile_kernel(const float* __restrict__ qx, const int* __restrict__ qid,
                const float* __restrict__ cx, const int* __restrict__ cid,
                float* __restrict__ out, int b, int c, int d) {
  __shared__ float qs[kRows * DMAX];
  __shared__ float qn[kRows];
  __shared__ int qi[kRows];

  const long long t = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool live = col < c;

  float cv[DMAX];
  float cc = 0.0f;
  int my_cid = -1;
  const float* crow = cx + (t * c + (live ? col : 0)) * d;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    cv[j] = (live && j < d) ? crow[j] : 0.0f;
    cc = __fadd_rn(cc, __fmul_rn(cv[j], cv[j]));
  }
  if (live) my_cid = cid[t * c + col];

  const float inf = __int_as_float(0x7f800000);
  for (int r0 = 0; r0 < b; r0 += kRows) {
    const int nr = min(kRows, b - r0);
    __syncthreads();  // the previous rows are no longer read
    const float* qrow = qx + (t * b + r0) * d;
    for (int e = threadIdx.x; e < nr * DMAX; e += kCols) {
      const int rr = e / DMAX, j = e % DMAX;
      qs[e] = j < d ? qrow[rr * d + j] : 0.0f;
    }
    if (threadIdx.x < nr) qi[threadIdx.x] = qid[t * b + r0 + threadIdx.x];
    __syncthreads();
    if (threadIdx.x < nr) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) {
        const float v = qs[threadIdx.x * DMAX + j];
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
      qn[threadIdx.x] = s;
    }
    __syncthreads();
    if (!live) continue;
    float* orow = out + (t * b + r0) * c + col;
    for (int rr = 0; rr < nr; ++rr) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) dot = fmaf(qs[rr * DMAX + j], cv[j], dot);
      const float d2 =
          fmaxf(__fsub_rn(__fadd_rn(qn[rr], cc), __fmul_rn(2.0f, dot)), 0.0f);
      const bool masked = my_cid < 0 || my_cid == qi[rr];
      orow[static_cast<long long>(rr) * c] = masked ? inf : d2;
    }
  }
}

template <int DMAX>
void launch(const void* qx, const void* qid, const void* cx, const void* cid,
            void* out, long long t, long long b, long long c, long long d,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(t),
                  static_cast<unsigned int>((c + kCols - 1) / kCols));
  knn_tile_kernel<DMAX><<<grid, kCols, 0, stream>>>(
      static_cast<const float*>(qx), static_cast<const int*>(qid),
      static_cast<const float*>(cx), static_cast<const int*>(cid),
      static_cast<float*>(out), static_cast<int>(b), static_cast<int>(c),
      static_cast<int>(d));
}

}  // namespace

// qx (t, b, d) fp32, qid (t, b) int32, cx (t, c, d) fp32, cid (t, c) int32,
// out (t, b, c) fp32, all contiguous; 1 <= d <= 64, t < 2^31, c < 2^22.
// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a d the kernel does not take.
extern "C" int knn_dist_tiles_f32(const void* qx, const void* qid,
                                  const void* cx, const void* cid, void* out,
                                  long long t, long long b, long long c,
                                  long long d, void* stream) {
  if (d < 1 || d > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (t <= 0 || b <= 0 || c <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 8) {
    launch<8>(qx, qid, cx, cid, out, t, b, c, d, s);
  } else if (d <= 16) {
    launch<16>(qx, qid, cx, cid, out, t, b, c, d, s);
  } else if (d <= 32) {
    launch<32>(qx, qid, cx, cid, out, t, b, c, d, s);
  } else {
    launch<64>(qx, qid, cx, cid, out, t, b, c, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
