// Segment reduce over CSR row bounds: out[i, :] = sum of vals[e, :] for e in
// [bounds[i], bounds[i+1]), accumulated in fp32; an empty row gives 0.
//
// Replaces: repro/kernels/segment_reduce.py:_seg_kernel (the Pallas TPU
// kernel behind segment_reduce_pallas).  That kernel folded each (R=128
// rows) x (C=256 edges) chunk into its rows with a one-hot matmul, because
// the TPU's matrix unit was its fastest adder, and held the whole (E, D)
// payload in VMEM.  Neither carries over: here one warp owns one output row.
//
// Design: one warp per output row.  The 32 lanes stride the row's
// contiguous span [bounds[i], bounds[i+1]) in steps of 32 edges, each lane
// summing its own edges in a fixed order, then a shuffle tree reduces the
// 32 partial sums.  The loop over the D payload columns is outermost, so a
// row is read D times; for D = 2 the second pass finds its lines in L1.
// No atomics: the order of every addition is fixed by the bounds alone, so
// the result is deterministic, and it is bit-exact against the cumsum
// difference whenever every partial sum is exact (integer-valued payloads
// below 2**24).
//
// Hubs: the src-side rows of the UMAP epoch have exactly k edges each
// (k = 15 at the paper's config: one pass of the lanes).  The dst-side rows
// are skewed: a hub with H incoming edges keeps its warp for ceil(H/32)
// dependent steps while the other warps of the grid move on, so a hub costs
// latency on one warp and no extra bytes.  With 8 warps per block and one
// block per 8 rows, the grid has ~N/8 blocks to spread over 132 SMs, so a
// few hubs do not idle the card.  Splitting a hub across a block is left
// for when measurements show hubs in the way.
//
// Bound: memory.  The call must read E*D*4 bytes of payload and
// (N+1)*4 bytes of bounds and write N*D*4 bytes.  At the main path's
// shapes on an H100 (N = 46 348, E = 695 220, D = 2: 6.1 MB) that bound is
// 1.83 us at 3.35 TB/s; the kernel's measured device time is 10.5 us,
// 5.8x the bound, so it is not the launch that dominates but this
// design's reads: the outer loop over D reads each row D times as
// stride-D scalar loads, and a 15-edge row leaves half its warp's lanes
// idle.  Reading each edge's payload once (float2 at D = 2) and giving a
// short row a part of a warp is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segment_reduce_kernel(const float* __restrict__ vals,
                      const int* __restrict__ bounds,
                      float* __restrict__ out, long long n_rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // whole warp leaves together: row is per warp
  const long long lo = bounds[row];
  const long long hi = bounds[row + 1];
  for (int c = 0; c < d; ++c) {
    float acc = 0.0f;
    for (long long e = lo + lane; e < hi; e += kWarp) {
      acc += vals[e * d + c];
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) out[row * d + c] = acc;
  }
}

}  // namespace

// vals (E, d) fp32 row-major, bounds (n_rows + 1) int32 ascending with
// bounds[n_rows] <= E, out (n_rows, d) fp32.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int segment_reduce_f32(const void* vals, const void* bounds,
                                  void* out, long long n_rows, long long d,
                                  void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_reduce_kernel<<<static_cast<unsigned int>(blocks),
                          kWarp * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(bounds),
      static_cast<float*>(out), n_rows, static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}
