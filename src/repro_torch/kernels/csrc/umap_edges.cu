// UMAP's per-edge epoch forces (K9 umap_edge_forces): for every edge e of
// the src-sorted list, with ys = y[src[e]], yd = y[dst[e]], m = memb[e],
//
//   att[e]  = clamp(-2ab d2^(b-1) / (1 + a d2^b) * (ys - yd), +-4) * m
//             (0 where d2 = |ys - yd|^2 is 0),
//   rep[e]  = sum over the edge's R negatives q, q != src[e], q != dst[e], of
//             clamp(2b / ((0.001 + dn2)(1 + a dn2^b)) * (ys - y[q]), +-4) * m,
//
// written as src_side[e] = att[e] + rep[e] (src order) and
// att_out[dst_pos[e]] = att[e] (dst-sorted order: dst_pos is the inverse of
// the layout's dst_order), the two payloads of the epoch's two segment
// reductions (K1).
//
// Replaces: no Pallas kernel.  The JAX package left the epoch's forces to
// XLA, which fuses the chain into a few loops.  Run op by op in PyTorch the
// chain was ~30 launches over (E, R, dims) temporaries, plus the gather of
// att into dst order, every epoch: the host's launches, not the card, paced
// UMAP's 300 epochs (~45 launches an epoch).  This kernel is that chain in
// one launch, with every temporary in registers.
//
// Design: one thread an edge.  Its two endpoint rows are one vector load
// each (float2 at dims 2, float4 at dims 4, a loop over at most 8 floats
// otherwise); each negative's row likewise.  The arithmetic is the plain
// chain's, operation for operation and rounding for rounding: no FMA
// contraction (__fmul_rn / __fadd_rn), IEEE division, 2b / x as the plain
// chain's reciprocal times 2b, powf at full precision, the R repulsions
// summed in order and added to the attraction last.  Only powf's last-bit
// rounding, and the order of the R-term sum, can differ from PyTorch's.
//
// Bound: memory.  An edge reads src, dst and dst_pos (24 B), its R int64
// negatives (8R B) and its membership (4 B), and writes two rows (2 * 4 * dims
// B); the (N, dims) positions it gathers are ~0.4 MB at the benchmark's
// shapes and stay in L2.  At dims 2, R 5 that is 84 B an edge: E = 695 220
// edges read and write 58 MB, 17.4 us at 3.35 TB/s.  Its 7 powf an edge are
// ~5 M special-function sequences, a few us across 132 SMs.  The scattered
// att store touches a 32-byte sector for 8 bytes; the (E, dims) output is
// a few MB and stays in L2 too.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

struct Coefs {
  float a;    // the curve's a
  float b;    // its b
  float bm1;  // b - 1
  float att;  // -2ab
  float rep;  // 2b
};

// torch.clamp(x, -4, 4): NaN passes through
__device__ __forceinline__ float clamp4(float x) {
  return x < -4.0f ? -4.0f : (x > 4.0f ? 4.0f : x);
}

// D = 2 or 4: one vector load; D = 0: d <= kMaxDims floats, zero past d.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ y,
                                         long long i, int d, float* v) {
  if constexpr (D == 2) {
    const float2 t = reinterpret_cast<const float2*>(y)[i];
    v[0] = t.x;
    v[1] = t.y;
  } else if constexpr (D == 4) {
    const float4 t = reinterpret_cast<const float4*>(y)[i];
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < kMaxDims; ++c) v[c] = c < d ? y[i * d + c] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          long long i, int d, const float* v) {
  if constexpr (D == 2) {
    reinterpret_cast<float2*>(out)[i] = make_float2(v[0], v[1]);
  } else if constexpr (D == 4) {
    reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxDims; ++c) {
      if (c < d) out[i * d + c] = v[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
umap_edge_forces_kernel(const float* __restrict__ y,
                        const long long* __restrict__ src,
                        const long long* __restrict__ dst,
                        const float* __restrict__ memb,
                        const long long* __restrict__ neg,
                        const long long* __restrict__ dst_pos,
                        float* __restrict__ src_side,
                        float* __restrict__ att_out, long long n_edges,
                        int d, int r, Coefs k) {
  constexpr int W = D > 0 ? D : kMaxDims;
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const long long s = src[e];
  const long long t = dst[e];
  const float m = memb[e];
  float ys[W], row[W], diff[W], att[W], rep[W];
  load_row<D>(y, s, d, ys);
  load_row<D>(y, t, d, row);
  float d2 = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    diff[c] = __fsub_rn(ys[c], row[c]);
    d2 = __fadd_rn(d2, __fmul_rn(diff[c], diff[c]));
  }
  float coef = 0.0f;
  if (d2 > 0.0f) {
    coef = __fdiv_rn(__fmul_rn(powf(d2, k.bm1), k.att),
                     __fadd_rn(__fmul_rn(powf(d2, k.b), k.a), 1.0f));
  }
#pragma unroll
  for (int c = 0; c < W; ++c) {
    att[c] = __fmul_rn(clamp4(__fmul_rn(coef, diff[c])), m);
    rep[c] = 0.0f;
  }
  const long long* q = neg + e * r;
  for (int j = 0; j < r; ++j) {
    const long long qj = q[j];
    if (qj == s || qj == t) continue;  // the plain chain's masked zero
    load_row<D>(y, qj, d, row);
    float dn2 = 0.0f;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      diff[c] = __fsub_rn(ys[c], row[c]);
      dn2 = __fadd_rn(dn2, __fmul_rn(diff[c], diff[c]));
    }
    const float den =
        __fmul_rn(__fadd_rn(dn2, 0.001f),
                  __fadd_rn(__fmul_rn(powf(dn2, k.b), k.a), 1.0f));
    const float rc = __fmul_rn(__frcp_rn(den), k.rep);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      rep[c] = __fadd_rn(rep[c], __fmul_rn(clamp4(__fmul_rn(rc, diff[c])), m));
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c) rep[c] = __fadd_rn(att[c], rep[c]);
  store_row<D>(src_side, e, d, rep);
  store_row<D>(att_out, dst_pos[e], d, att);
}

template <int D>
int launch(const float* y, const long long* src, const long long* dst,
           const float* memb, const long long* neg, const long long* dst_pos,
           float* src_side, float* att_out, long long n_edges, int d, int r,
           Coefs k, cudaStream_t stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((n_edges + kThreads - 1) / kThreads);
  umap_edge_forces_kernel<D><<<blocks, kThreads, 0, stream>>>(
      y, src, dst, memb, neg, dst_pos, src_side, att_out, n_edges, d, r, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (N, d) fp32 row-major (8-byte aligned at d = 2, 16-byte at d = 4), src,
// dst, dst_pos (E,) int64, memb (E,) fp32, neg (E, r) int64 row-major, every
// id in [0, N) and dst_pos a permutation of [0, E); src_side and att_out
// (E, d) fp32, aligned as y.  a, b, bm1 = b - 1, att = -2ab and rep = 2b
// are the plain chain's scalars rounded to fp32.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched; cudaErrorInvalidValue for d
// outside [1, 8] or r < 0).
extern "C" int umap_edge_forces_f32(
    const void* y, const void* src, const void* dst, const void* memb,
    const void* neg, const void* dst_pos, void* src_side, void* att_out,
    long long n_edges, long long d, long long r, float a, float b, float bm1,
    float att, float rep, void* stream) {
  if (d < 1 || d > kMaxDims || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_edges <= 0) return 0;
  const float* yp = static_cast<const float*>(y);
  const long long* sp = static_cast<const long long*>(src);
  const long long* dp = static_cast<const long long*>(dst);
  const float* mp = static_cast<const float*>(memb);
  const long long* np_ = static_cast<const long long*>(neg);
  const long long* pp = static_cast<const long long*>(dst_pos);
  float* so = static_cast<float*>(src_side);
  float* ao = static_cast<float*>(att_out);
  const Coefs k{a, b, bm1, att, rep};
  const int di = static_cast<int>(d);
  const int ri = static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (di) {
    case 2: return launch<2>(yp, sp, dp, mp, np_, pp, so, ao, n_edges, di,
                             ri, k, s);
    case 4: return launch<4>(yp, sp, dp, mp, np_, pp, so, ao, n_edges, di,
                             ri, k, s);
    default: return launch<0>(yp, sp, dp, mp, np_, pp, so, ao, n_edges, di,
                              ri, k, s);
  }
}
