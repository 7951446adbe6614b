// Segment reduce over CSR row bounds: out[i, :] = sum of vals[e, :] for e in
// [bounds[i], bounds[i+1]), accumulated in fp32; an empty row gives 0.
//
// Replaces: repro/kernels/segment_reduce.py:_seg_kernel (the Pallas TPU
// kernel behind segment_reduce_pallas).  That kernel folded each (R=128
// rows) x (C=256 edges) chunk into its rows with a one-hot matmul, because
// the TPU's matrix unit was its fastest adder, and held the whole (E, D)
// payload in VMEM.  Neither carries over: here a group of lanes owns a row.
//
// Design: a group of L lanes (L a power of two, 1..32, a segment of one
// warp) owns one output row.  The host picks L per launch from the shapes
// alone, with no sync: the smallest power of two >= ceil(E / 2N), capped at
// 32, so a mean row takes about two strides of its group (L = 8 at the
// UMAP epoch's 15-edge rows, 32 at path S's ~180).  The lanes of a group
// stride the row's span [bounds[i], bounds[i+1]) by L edges, each summing
// its own edges in a fixed order; a fixed __shfl_down_sync tree of width L
// then reduces the group, and its first lane writes the row.  Each edge's
// D floats are one load (float2 at D = 2, the only D of the main path;
// float at D = 1; a short unrolled loop otherwise), so the payload is read
// once, and each row is one store.  No atomics: the order of every
// addition is fixed by the bounds and L, so the result is deterministic,
// and bit-exact against the cumsum difference whenever every partial sum
// is exact (integer-valued payloads whose sums stay below 2**24).
//
// Hubs: the src-side rows of the UMAP epoch have exactly k edges each
// (k = 15 at the paper's config).  The dst-side rows are skewed: a hub
// with H incoming edges keeps its group for ceil(H/L) dependent steps
// while the other groups move on; it costs latency on one group and no
// extra bytes.  Splitting a hub across groups is the next step if the dst
// side stays behind the library while the src side beats it.
//
// Bound: memory.  The call must read E*D*4 bytes of payload and
// (N+1)*4 bytes of bounds and write N*D*4 bytes.  At the UMAP epoch's
// shapes (N = 46 348, E = 695 220, D = 2: 6.1 MB) that is 1.83 us at
// 3.35 TB/s.  The design this replaces (one warp a row, D passes of
// stride-D scalar loads) took 10.61 us there, and torch.segment_reduce
// 5.19 us (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W); PERF.md keeps
// this design's times beside them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // columns a pass of the generic-D kernel

// L lanes a row.  D = 1 or 2: the payload row is one float / float2 load.
// D = 0: any d, in passes of kChunk columns, each edge's columns of a pass
// read by one unrolled loop (one pass, so one read of the row, for d <= 4).
template <int L, int D>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ vals,
                      const int* __restrict__ bounds,
                      float* __restrict__ out, long long n_rows, int d) {
  constexpr int W = D > 0 ? D : kChunk;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const int sub = threadIdx.x % L;
  // rows past the end stay in the warp (empty span) for the full-warp
  // shuffles below
  const bool live = row < n_rows;
  const long long lo = live ? bounds[row] : 0;
  const long long hi = live ? bounds[row + 1] : 0;
  for (int c0 = 0; c0 < d; c0 += W) {
    const int w = min(W, d - c0);
    float acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0f;
    for (long long e = lo + sub; e < hi; e += L) {
      if constexpr (D == 2) {
        const float2 x = reinterpret_cast<const float2*>(vals)[e];
        acc[0] += x.x;
        acc[1] += x.y;
      } else if constexpr (D == 1) {
        acc[0] += vals[e];
      } else {
        const float* v = vals + e * d + c0;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          if (c < w) acc[c] += v[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off, L);
      }
    }
    if (live && sub == 0) {
      if constexpr (D == 2) {
        reinterpret_cast<float2*>(out)[row] = make_float2(acc[0], acc[1]);
      } else if constexpr (D == 1) {
        out[row] = acc[0];
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          if (c < w) out[row * d + c0 + c] = acc[c];
        }
      }
    }
  }
}

template <int L>
int launch(const float* vals, const int* bounds, float* out, long long n,
           int d, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kRows - 1) / kRows);
  if (d == 2) {
    segment_reduce_kernel<L, 2><<<blocks, kThreads, 0, stream>>>(
        vals, bounds, out, n, d);
  } else if (d == 1) {
    segment_reduce_kernel<L, 1><<<blocks, kThreads, 0, stream>>>(
        vals, bounds, out, n, d);
  } else {
    segment_reduce_kernel<L, 0><<<blocks, kThreads, 0, stream>>>(
        vals, bounds, out, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (E, d) fp32 row-major (8-byte aligned at d = 2), bounds (n_rows + 1)
// int32 ascending with bounds[n_rows] <= E, out (n_rows, d) fp32; lanes the
// group width L in {1, 2, 4, 8, 16, 32}.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched; cudaErrorInvalidValue for another L).
extern "C" int segment_reduce_f32(const void* vals, const void* bounds,
                                  void* out, long long n_rows, long long d,
                                  long long lanes, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const float* v = static_cast<const float*>(vals);
  const int* b = static_cast<const int*>(bounds);
  float* o = static_cast<float*>(out);
  const int di = static_cast<int>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch<1>(v, b, o, n_rows, di, s);
    case 2: return launch<2>(v, b, o, n_rows, di, s);
    case 4: return launch<4>(v, b, o, n_rows, di, s);
    case 8: return launch<8>(v, b, o, n_rows, di, s);
    case 16: return launch<16>(v, b, o, n_rows, di, s);
    case 32: return launch<32>(v, b, o, n_rows, di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
