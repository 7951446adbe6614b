// The Count Sketch's three kernels: K6 hash_points (quantize -> pack ->
// hash a block of points), K7 sketch_update_table (hash keys and add
// sign * value into the (R, C) table) and K8 sketch_estimate_table (hash
// keys, gather sign * table[r, bucket] and take the median over rows:
// sketch.estimate).
//
// Hash family (core/hashing.py, Thorup's vector multiply-shift): a 64-bit
// key x = (x_hi, x_lo) and 64-bit parameters (a1, a2, b) of row r give
//   h = a1 * x_hi + a2 * x_lo + b  (mod 2^64),
//   bucket = h >> (64 - l),  sign = 1 - 2 * (h >> 63).
// The port carries every 64-bit quantity as two uint32 limbs in int64
// tensors (core/u64.py, the reference's limb arithmetic); Hopper has
// native 64-bit integer multiplies, so here a key and a parameter are one
// uint64 each and the limb arithmetic disappears.  K6 and K7 share
// mulshift() below.  Parameters arrive as the six (R,) int64 limb
// tensors of hashing.MulShiftParams [a1_hi, a1_lo, a2_hi, a2_lo, b_hi,
// b_lo], one pointer each (no per-call stacking), and are staged in
// shared memory as R (a1, a2, b) triples by every block.
//
// K6 replaces repro/kernels/hash_points.py:_kernel (the Pallas TPU kernel
// behind ops.hash_points), which quantized, packed and hashed a
// (block_items, D) tile in VMEM with uint32 limb arithmetic on the VPU.
// Design: one thread per point.  It quantizes each coordinate as
// floor((p - lo) * inv) clamped to [0, bins - 1], with the subtraction
// and the product rounded one by one (__fsub_rn, __fmul_rn; this file is
// never built with -use_fast_math), so the cell coordinates equal
// quantize.quantize's on the CPU bit for bit, points on a bin edge
// included; packs bits_per_dim bits a dimension into one uint64; then
// writes its R buckets and R signs, row r at [r * N + i], so a warp's
// stores are contiguous.  Outputs are int64, the dtypes hashing.hashes
// returns (buckets holding uint32, signs +-1).
// Bound: memory.  The call reads N*D*4 bytes of points and writes
// 2*R*N*8 bytes of int64 buckets and signs; the outputs dominate (16.8 MB
// at R = 16 and a 65 536-point chunk: 5.0 us at 3.35 TB/s).  The int64
// outputs are the port's key dtype; a uint32 bucket and an int8 sign
// would cut the bytes 5x, for callers that take those dtypes.
//
// K7 replaces repro/kernels/sketch_update.py:_kernel (behind
// ops.sketch_update_fused).  The TPU has no atomics, so that kernel kept
// the table in VMEM as a revisited output block and added item by item
// with serialised scalar stores; its own note says atomics are what the
// paper's GPU code did.  Design: one thread per item hashes the key R
// times in registers and issues R atomicAdds whose result is unused (they
// compile to RED).  No (R, N) hash temporaries exist.  An item whose value
// is 0 adds nothing and is skipped: a table that starts at +0.0 never
// holds -0.0 (x + (-x) is +0.0 under round-to-nearest), so skipping an
// add of +-0 changes no bit, and the dead slots of a run-length-encoded
// chunk (count 0, all on the chunk's largest key, a suffix) cost one load
// each and no atomics on one hot cell.  Integer-valued sums are exact in
// any order while every partial sum stays below 2^24, so integer tables
// equal the plain version's bit for bit; weighted values agree to fp32
// rounding.  The call adds into the table it is given (the wrapper
// allocates nothing).
// Bound: memory.  The call reads N * 4 bytes of values, 16 bytes of keys
// for each live item, and read-modify-writes the touched cells of 4 bytes
// (at most R per live item); the table (16 MiB at R = 16, C = 2^18) stays
// in the 50 MB L2, so the adds cost L2, not device-memory, bandwidth.  In
// practice the L2's rate of scattered fp32 atomics bounds both a chunk and
// the one-shot call, not parallelism: a layout that gave a chunk's live
// items 4-16x the warps (a warp a group of 32 items and a slice of the
// rows) was no faster at any slice, and the kernel with its adds removed
// takes a third of the time (chip_k7_layouts.py, PERF.md section 6).
//
// K8 replaces repro/kernels/sketch_estimate.py:_kernel (behind
// ops.sketch_estimate_mxu) and the median the reference takes after it
// (ops.py; sketch.estimate's jnp.median over rows).  A TPU gathers
// slowly, so that kernel contracted a one-hot (Q_tile x C_tile)
// indicator with the table on the MXU, R*Q*C multiply-adds, fed with
// precomputed (R, Q) buckets and signs, and left the median to XLA.
// Design: one thread per query.  The block stages the R hash triples in
// shared memory (stage_params, as K6 and K7), so the hash is the one the
// table was built with; the thread hashes its key R times (mulshift),
// issues its R gathers table[r * C + bucket_r] back to back, so R loads
// are in flight at once, and negates by the sign (exact).  It takes the
// median in registers: each value's stable rank
//   rank_i = #{j : v_j < v_i} + #{j < i : v_j == v_i}
// (O(R^2) comparisons; NaN above every number and NaNs equal, the order
// torch.sort gives), then (v at rank (R-1)/2 + v at rank R/2) * 0.5 with
// the add and the product rounded one by one (__fadd_rn, __fmul_rn).
// That is sketch.median_rows' stable sort and jnp.median's: -0.0 and
// +0.0 compare equal and keep their row order, so even the sign of a
// zero estimate matches, which candidates.topk_desc's total order sees.
// One coalesced f32 store a query; no (R, Q) tensor and no sort exist.
// Keys come from two sources in one body: explicit (key_hi, key_lo)
// uint32 limbs in int64 (sketch.estimate), or implicitly (0, start + j)
// for the dense-vector sketch (tensor_sketch_estimate), whose thread j
// writes out[j] of the caller's slice.  R = 8 and R = 16 (every config)
// are compiled with the values in registers; any other R up to
// kMaxEstimateRows keeps each thread's column in shared memory.  Above
// that (the reference takes any R) a warp serves a query: its lanes
// gather the R signed values into a row of a scratch the wrapper
// allocates (one row a resident warp, the queries taken in a
// grid-stride loop), then each lane ranks its rows against all R (the
// same stable rank, the reads broadcast), and the two lanes that hold
// ranks (R-1)/2 and R/2 hand them to lane 0 by shuffle.
// Bound: memory.  16 bytes of keys read (explicit keys only) and 4 bytes
// of output written a query, plus the table cells the queries touch, 4
// bytes each, where the call finds them outside L2.  Beside that bound
// the R*Q gathers move R*Q scattered 32-byte L2 sectors: with the table
// in the 50 MB L2 (16 MiB at R 16, C 2^18; 32 MiB at R 8, C 2^20) they,
// not device memory, pace the kernel at large Q.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// K8: a thread a query.  R other than 8 and 16 keeps a block's R
// triples and kGeneralThreads columns of R floats in shared memory: 35 KB
// at kMaxEstimateRows, under the 48 KB a block has without the opt-in.
constexpr int kEstimateThreads = 128;
constexpr int kGeneralThreads = 64;
constexpr int kMaxEstimateRows = 128;
// R > kMaxEstimateRows: warps a block, and blocks at most (the scratch
// the wrapper allocates is kWideWarps * kWideBlocks rows of R floats).
constexpr int kWideWarps = 8;
constexpr int kWideBlocks = 1024;

struct MulShift {
  uint64_t a1, a2, b;
};

// The six (R,) int64 limb arrays of hashing.MulShiftParams.
struct ParamLimbs {
  const long long* a1_hi;
  const long long* a1_lo;
  const long long* a2_hi;
  const long long* a2_lo;
  const long long* b_hi;
  const long long* b_lo;
};

__device__ __forceinline__ uint64_t join(const long long* hi,
                                         const long long* lo, int r) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(hi[r])) << 32) |
         static_cast<uint32_t>(lo[r]);
}

// R triples into shared memory; every thread of the block takes part,
// then the block waits for the table.
__device__ __forceinline__ void stage_params(const ParamLimbs& p, int rows,
                                             MulShift* out) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    out[r] = MulShift{join(p.a1_hi, p.a1_lo, r), join(p.a2_hi, p.a2_lo, r),
                      join(p.b_hi, p.b_lo, r)};
  }
  __syncthreads();
}

__device__ __forceinline__ uint64_t mulshift(const MulShift& p,
                                             uint64_t key) {
  return p.a1 * (key >> 32) + p.a2 * (key & 0xFFFFFFFFull) + p.b;
}

__global__ void __launch_bounds__(kThreads)
hash_points_kernel(const float* __restrict__ points,
                   const float* __restrict__ lo,
                   const float* __restrict__ inv, ParamLimbs params,
                   long long* __restrict__ buckets,
                   long long* __restrict__ signs, long long n, int d,
                   int rows, int bins, int bits, int log2_cols) {
  extern __shared__ MulShift hp[];
  stage_params(params, rows, hp);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const float* p = points + i * d;
  const float top = static_cast<float>(bins - 1);
  uint64_t key = 0;
  for (int k = 0; k < d; ++k) {
    float t = floorf(__fmul_rn(__fsub_rn(p[k], lo[k]), inv[k]));
    t = fminf(fmaxf(t, 0.0f), top);
    key = (key << bits) | static_cast<uint64_t>(static_cast<uint32_t>(t));
  }
  for (int r = 0; r < rows; ++r) {
    const uint64_t h = mulshift(hp[r], key);
    buckets[r * n + i] = static_cast<long long>(h >> (64 - log2_cols));
    signs[r * n + i] = 1 - 2 * static_cast<long long>(h >> 63);
  }
}

__global__ void __launch_bounds__(kThreads)
sketch_update_kernel(const long long* __restrict__ key_hi,
                     const long long* __restrict__ key_lo,
                     const float* __restrict__ values, ParamLimbs params,
                     float* __restrict__ table, long long n, int rows,
                     int log2_cols) {
  extern __shared__ MulShift hp[];
  stage_params(params, rows, hp);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const float v = values[i];
  if (v == 0.0f) return;
  const uint64_t key =
      (static_cast<uint64_t>(static_cast<uint32_t>(key_hi[i])) << 32) |
      static_cast<uint32_t>(key_lo[i]);
  for (int r = 0; r < rows; ++r) {
    const uint64_t h = mulshift(hp[r], key);
    const uint64_t cell =
        (static_cast<uint64_t>(r) << log2_cols) | (h >> (64 - log2_cols));
    atomicAdd(table + cell, (h >> 63) ? -v : v);
  }
}

// NaN after every number, NaNs equal: the order torch.sort sorts in.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (b != b && a == a);
}

__device__ __forceinline__ uint64_t query_key(const long long* key_hi,
                                              const long long* key_lo,
                                              long long start, long long j) {
  if (key_lo == nullptr) {
    return static_cast<uint32_t>(start + j);
  }
  return (static_cast<uint64_t>(static_cast<uint32_t>(key_hi[j])) << 32) |
         static_cast<uint32_t>(key_lo[j]);
}

__device__ __forceinline__ float signed_cell(const float* __restrict__ table,
                                             const MulShift& p, uint64_t key,
                                             int r, int log2_cols) {
  const uint64_t h = mulshift(p, key);
  const uint64_t cell =
      (static_cast<uint64_t>(r) << log2_cols) | (h >> (64 - log2_cols));
  const float v = __ldg(table + cell);
  return (h >> 63) ? -v : v;
}

// The median of R values held in registers, by stable rank.
template <int R>
__device__ __forceinline__ float median_of(const float (&v)[R]) {
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j < i) rank += !before(v[i], v[j]);
      if (j > i) rank += before(v[j], v[i]);
    }
    lo = rank == (R - 1) / 2 ? v[i] : lo;
    hi = rank == R / 2 ? v[i] : hi;
  }
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

template <int R>
__global__ void __launch_bounds__(kEstimateThreads)
sketch_estimate_kernel(const float* __restrict__ table,
                       const long long* __restrict__ key_hi,
                       const long long* __restrict__ key_lo,
                       ParamLimbs params, float* __restrict__ out,
                       long long n, long long start, int log2_cols) {
  __shared__ MulShift hp[R];
  stage_params(params, R, hp);
  const long long j = static_cast<long long>(blockIdx.x) * kEstimateThreads +
                      threadIdx.x;
  if (j >= n) return;
  const uint64_t key = query_key(key_hi, key_lo, start, j);
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = signed_cell(table, hp[r], key, r, log2_cols);
  }
  out[j] = median_of<R>(v);
}

// Any other R: the R triples, then each thread's R values as a column
// (stride kGeneralThreads, so a warp's accesses hit distinct banks).
__global__ void __launch_bounds__(kGeneralThreads)
sketch_estimate_general_kernel(const float* __restrict__ table,
                               const long long* __restrict__ key_hi,
                               const long long* __restrict__ key_lo,
                               ParamLimbs params, float* __restrict__ out,
                               long long n, long long start, int rows,
                               int log2_cols) {
  extern __shared__ MulShift hp[];
  stage_params(params, rows, hp);
  const long long j = static_cast<long long>(blockIdx.x) * kGeneralThreads +
                      threadIdx.x;
  if (j >= n) return;
  float* v = reinterpret_cast<float*>(hp + rows) + threadIdx.x;
  const uint64_t key = query_key(key_hi, key_lo, start, j);
  for (int r = 0; r < rows; ++r) {
    v[r * kGeneralThreads] = signed_cell(table, hp[r], key, r, log2_cols);
  }
  float lo = 0.0f, hi = 0.0f;
  for (int i = 0; i < rows; ++i) {
    const float vi = v[i * kGeneralThreads];
    int rank = 0;
    for (int k = 0; k < i; ++k) rank += !before(vi, v[k * kGeneralThreads]);
    for (int k = i + 1; k < rows; ++k) {
      rank += before(v[k * kGeneralThreads], vi);
    }
    lo = rank == (rows - 1) / 2 ? vi : lo;
    hi = rank == rows / 2 ? vi : hi;
  }
  out[j] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// R > kMaxEstimateRows: a warp a query (see the note at the top).  The
// parameters are read from the limb arrays directly (R triples may not
// fit in shared memory); scratch holds gridDim.x * kWideWarps rows of R.
__global__ void __launch_bounds__(kWideWarps * 32)
sketch_estimate_wide_kernel(const float* __restrict__ table,
                            const long long* __restrict__ key_hi,
                            const long long* __restrict__ key_lo,
                            ParamLimbs params, float* __restrict__ out,
                            float* __restrict__ scratch, long long n,
                            long long start, int rows, int log2_cols) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWideWarps + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * kWideWarps;
  float* v = scratch + warp * rows;
  for (long long j = warp; j < n; j += warps) {
    const uint64_t key = query_key(key_hi, key_lo, start, j);
    for (int r = lane; r < rows; r += 32) {
      const MulShift p{join(params.a1_hi, params.a1_lo, r),
                       join(params.a2_hi, params.a2_lo, r),
                       join(params.b_hi, params.b_lo, r)};
      v[r] = signed_cell(table, p, key, r, log2_cols);
    }
    __syncwarp();
    float lo = 0.0f, hi = 0.0f;
    bool has_lo = false, has_hi = false;
    for (int i = lane; i < rows; i += 32) {
      const float vi = v[i];
      int rank = 0;
      for (int k = 0; k < i; ++k) rank += !before(vi, v[k]);
      for (int k = i + 1; k < rows; ++k) rank += before(v[k], vi);
      if (rank == (rows - 1) / 2) {
        lo = vi;
        has_lo = true;
      }
      if (rank == rows / 2) {
        hi = vi;
        has_hi = true;
      }
    }
    const int src_lo = __ffs(__ballot_sync(0xFFFFFFFFu, has_lo)) - 1;
    const int src_hi = __ffs(__ballot_sync(0xFFFFFFFFu, has_hi)) - 1;
    lo = __shfl_sync(0xFFFFFFFFu, lo, src_lo);
    hi = __shfl_sync(0xFFFFFFFFu, hi, src_hi);
    if (lane == 0) out[j] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    __syncwarp();              // the row is rewritten for the next query
  }
}

unsigned int blocks_for(long long n, int threads = kThreads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

ParamLimbs limbs(const void* a1_hi, const void* a1_lo, const void* a2_hi,
                 const void* a2_lo, const void* b_hi, const void* b_lo) {
  return ParamLimbs{static_cast<const long long*>(a1_hi),
                    static_cast<const long long*>(a1_lo),
                    static_cast<const long long*>(a2_hi),
                    static_cast<const long long*>(a2_lo),
                    static_cast<const long long*>(b_hi),
                    static_cast<const long long*>(b_lo)};
}

template <int R>
void launch_estimate(const float* table, const long long* key_hi,
                     const long long* key_lo, ParamLimbs params, float* out,
                     long long n, long long start, int log2_cols,
                     cudaStream_t stream) {
  sketch_estimate_kernel<R><<<blocks_for(n, kEstimateThreads),
                              kEstimateThreads, 0, stream>>>(
      table, key_hi, key_lo, params, out, n, start, log2_cols);
}

}  // namespace

// points (n, d) f32, lo/inv (d,) f32, the six (rows,) int64 limb arrays
// of the hash params, buckets/signs (rows, n) int64 out.  Returns
// cudaGetLastError().
extern "C" int hash_points_f32(const void* points, const void* lo,
                               const void* inv, const void* a1_hi,
                               const void* a1_lo, const void* a2_hi,
                               const void* a2_lo, const void* b_hi,
                               const void* b_lo, void* buckets, void* signs,
                               long long n, long long d, long long rows,
                               long long bins, long long bits,
                               long long log2_cols, void* stream) {
  if (n <= 0) return 0;
  hash_points_kernel<<<blocks_for(n), kThreads, rows * sizeof(MulShift),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(lo),
      static_cast<const float*>(inv),
      limbs(a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo),
      static_cast<long long*>(buckets), static_cast<long long*>(signs), n,
      static_cast<int>(d), static_cast<int>(rows), static_cast<int>(bins),
      static_cast<int>(bits), static_cast<int>(log2_cols));
  return static_cast<int>(cudaGetLastError());
}

// key_hi/key_lo (n,) int64 holding uint32, values (n,) f32, the six
// (rows,) int64 limb arrays of the hash params; adds into table
// (rows, 2^log2_cols) f32 in place.  Returns cudaGetLastError().
extern "C" int sketch_update_f32(const void* key_hi, const void* key_lo,
                                 const void* values, const void* a1_hi,
                                 const void* a1_lo, const void* a2_hi,
                                 const void* a2_lo, const void* b_hi,
                                 const void* b_lo, void* table, long long n,
                                 long long rows, long long log2_cols,
                                 void* stream) {
  if (n <= 0) return 0;
  sketch_update_kernel<<<blocks_for(n), kThreads, rows * sizeof(MulShift),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key_hi),
      static_cast<const long long*>(key_lo),
      static_cast<const float*>(values),
      limbs(a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo),
      static_cast<float*>(table), n, static_cast<int>(rows),
      static_cast<int>(log2_cols));
  return static_cast<int>(cudaGetLastError());
}

// table (rows, 2^log2_cols) f32, the six (rows,) int64 limb arrays of the
// hash params; out (n,) f32 gets the estimate of query j: key (key_hi[j],
// key_lo[j]) (int64 holding uint32), or (0, start + j) when key_hi and
// key_lo are null.  rows >= 1; above kMaxEstimateRows, scratch holds
// sketch_estimate_scratch_rows(n) rows of R floats (unused otherwise,
// may be null).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for R < 1 or a missing scratch.
extern "C" int sketch_estimate_median_f32(
    const void* table, const void* key_hi, const void* key_lo,
    const void* a1_hi, const void* a1_lo, const void* a2_hi,
    const void* a2_lo, const void* b_hi, const void* b_lo, void* out,
    void* scratch, long long n, long long start, long long rows,
    long long log2_cols, void* stream) {
  if (rows < 1 || (rows > kMaxEstimateRows && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const float* t = static_cast<const float*>(table);
  const long long* hi = static_cast<const long long*>(key_hi);
  const long long* lo = static_cast<const long long*>(key_lo);
  const ParamLimbs p = limbs(a1_hi, a1_lo, a2_hi, a2_lo, b_hi, b_lo);
  float* o = static_cast<float*>(out);
  const int l = static_cast<int>(log2_cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > kMaxEstimateRows) {
    const long long blocks = (n + kWideWarps - 1) / kWideWarps;
    sketch_estimate_wide_kernel<<<static_cast<unsigned int>(
                                      blocks < kWideBlocks ? blocks
                                                           : kWideBlocks),
                                  kWideWarps * 32, 0, s>>>(
        t, hi, lo, p, o, static_cast<float*>(scratch), n, start,
        static_cast<int>(rows), l);
    return static_cast<int>(cudaGetLastError());
  }
  if (rows == 8) {
    launch_estimate<8>(t, hi, lo, p, o, n, start, l, s);
  } else if (rows == 16) {
    launch_estimate<16>(t, hi, lo, p, o, n, start, l, s);
  } else {
    const size_t smem = rows * (sizeof(MulShift) +
                                kGeneralThreads * sizeof(float));
    sketch_estimate_general_kernel<<<blocks_for(n, kGeneralThreads),
                                     kGeneralThreads, smem, s>>>(
        t, hi, lo, p, o, n, start, static_cast<int>(rows), l);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows of R floats the scratch of an R > kMaxEstimateRows call of n
// queries needs: one a resident warp.
extern "C" long long sketch_estimate_scratch_rows(long long n) {
  const long long blocks = (n + kWideWarps - 1) / kWideWarps;
  return (blocks < kWideBlocks ? blocks : kWideBlocks) * kWideWarps;
}
