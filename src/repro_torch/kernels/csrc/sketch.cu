// The Count Sketch's three kernels: K6 hash_points (quantize -> pack ->
// hash a block of points), K7 sketch_update_table (hash keys and add
// sign * value into the (R, C) table) and K8 sketch_estimate_table (the
// signed gather sign * table[r, bucket] that sketch.estimate takes the
// median of).
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
// ops.sketch_estimate_mxu).  A TPU gathers slowly, so that kernel
// contracted a one-hot (Q_tile x C_tile) indicator with the table on the
// MXU, R*Q*C multiply-adds.  Design: one thread per (r, q) reads its
// bucket and sign and gathers one table value: R*Q loads instead of
// R*Q*C MACs.  sign * value is exact, so the result equals the plain
// version bit for bit.  The median over rows stays outside, as in the
// reference (ops.py takes it after the kernel).
// Bound: memory.  R*Q*(8 + 8 + 4) bytes of buckets, signs and output plus
// the R*Q table values gathered (4 bytes each, from L2 when the table
// fits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
sketch_estimate_kernel(const float* __restrict__ table,
                       const long long* __restrict__ buckets,
                       const long long* __restrict__ signs,
                       float* __restrict__ out, long long q, long long cols,
                       long long total) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (j >= total) return;
  const long long r = j / q;
  out[j] = table[r * cols + buckets[j]] * static_cast<float>(signs[j]);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
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

// table (rows, cols) f32, buckets/signs (rows, q) int64 with buckets in
// [0, cols), out (rows, q) f32.
extern "C" int sketch_estimate_f32(const void* table, const void* buckets,
                                   const void* signs, void* out,
                                   long long rows, long long cols,
                                   long long q, void* stream) {
  const long long total = rows * q;
  if (total <= 0) return 0;
  sketch_estimate_kernel<<<blocks_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table),
      static_cast<const long long*>(buckets),
      static_cast<const long long*>(signs), static_cast<float*>(out), q,
      cols, total);
  return static_cast<int>(cudaGetLastError());
}
