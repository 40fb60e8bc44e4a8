// Fused score + slot-bank fold over packed int4 rows (Hopper, sm_90a): the
// coarse scan of the int4 flat tier.
//
// Replaces memex_tpu/ops/fused_topk.py::_fused_kernel_int4q. Row n holds
// D/2 signed bytes b = 16 * hi + lo, hi = code[n, j + D/2], lo = code[n, j],
// both in [-7, 7] (not nibble-packed; fused_topk.py:530-534). The port keeps
// the packed rows row-major, [n_rows, D/2], where the TPU keeps them
// transposed for its 128-lane tiles: here a warp reads a row's 192 bytes
// (D = 384) contiguously. Two scorings, as on the TPU:
//   shift    -- t = b + 8; hi = t >> 4, lo = (t & 15) - 8; two s8 dots of
//               the int8 query halves against lo and hi (exact, int32);
//   deferred -- only hi is extracted; q_lo . b + (q_hi - 16 q_lo) . hi with
//               the two query operands as bf16 values (the wrapper rounds
//               them), FP32 FMA. Every product and partial sum is an integer
//               below 2^24 at D = 384, so this is exact too.
// The score is raw * (scales8[col] * 127/7), the int4 row scale, computed in
// that order as the TPU wrapper does; the query's own scale is not applied
// (ranking within a query does not depend on it). Masks and fold as K1.
//
// What bounds it: HBM bytes, N * (D/2 + 4) per batch (0.2 GB at 1M x 384,
// 0.06 ms), and the unpack. Both modes run slot_bank.cuh's tensor-core body
// at every batch size, 8 slots a block, up to 64 queries a warp and, past
// that, two warps a slot, each on its own queries. A lane unpacks the ring
// words of its fragment once per 16 rows, not per query:
//   shift    -- four byte-parallel operations a word (__vadd4 / mask /
//               __vsub4) give a `lo` and a `hi` word, the A operands of two
//               chains of mma.sync m16n8k32 s8 x s8 -> s32 into one
//               accumulator, against the q_lo and the q_hi part of the tile;
//   deferred -- in2 reaches 2,159 in magnitude and does not fit s8, so this
//               mode takes a 16-bit float product (m16n8k16, f32
//               accumulate), in f16: a word's bytes b and its hi parts
//               become f16 pairs without the conversion pipe (the byte
//               placed under the exponent of 1,024, less 1,024 and the
//               offset, two values an instruction), against f16 parts of
//               in1 and in2. Both are bf16 numbers, of at most 8
//               significant bits and far below 65,504, so f16 holds them
//               exactly, as it holds b and hi; every partial sum is an
//               integer below 2^24, so the f32 accumulation is exact in any
//               order.
// A lone query runs the same body on a 16-query tile: measured at 1M x 384,
// 0.12-0.13 ms where the SIMT one-query walk (__dp4a or FP32 FMA against the
// query in shared memory, one warp a slot with its own cp.async ring) took
// 0.44-0.49.
// The wrapper's query operands (the queries' int8 quantization, split or
// combined as the mode asks) are made by query_operands_kernel below, one
// launch in place of a dozen small ones.

#include <cuda_fp16.h>

#include "slot_bank.cuh"

namespace {

constexpr int kMaxDim = 384;  // the int8 tier's limit (its rerank rows)

// hi byte of each packed byte: t = b + 8 = 16 * hi + (lo + 8), lo + 8 in
// [1, 15], so bits 4..7 of t are hi mod 16; (n ^ 8) - 8 sign-extends them.
__device__ __forceinline__ uint32_t unpack_hi(uint32_t t) {
  return __vsub4(((t >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

constexpr int kSlots = 8;  // a block's slots on the tensor-core body

// Shift mode: the tensor-core body's s8 product. A
// tile row is the query's q_lo codes then its q_hi codes, each part as
// fused_topk_int8.cu's. A k-step is 32 packed bytes; a d / 2 that is only a
// multiple of 16 ends on the parts' zero bytes.
struct ShiftMmaOp {
  using Acc = int;
  static constexpr int kTail = 80;
  static constexpr int kMaxRowBytes = kMaxDim / 2;
  __host__ __device__ static constexpr int max_tile_bytes(int tq) {
    return tq * (2 * memex::round_up(kMaxDim / 2, 32) + 16);
  }
  const char* q_lo;  // [n_q, d2] int8 q8[:, :D/2]
  const char* q_hi;  // [n_q, d2] int8 q8[:, D/2:]
  const void* db;    // [n_rows, d2] packed rows
  int d2;            // bytes per packed row: d / 2

  __host__ __device__ int row_bytes() const { return d2; }
  __host__ __device__ int part_bytes() const { return memex::round_up(d2, 32); }
  __host__ __device__ int tile_stride() const { return 2 * part_bytes() + 16; }
  __host__ __device__ int tile_bytes(int tq) const { return tq * tile_stride(); }

  __device__ __forceinline__ void stage_tile(char* tile, int q0, int nq, int tq) const {
    memex::stage_s8_tile(tile, tile_stride(), q_lo, d2, part_bytes(), q0, nq, tq);
    memex::stage_s8_tile(tile + part_bytes(), tile_stride(), q_hi, d2, part_bytes(), q0, nq, tq);
  }

  template <int kNT, int kMT>
  __device__ __forceinline__ void products(int (&acc)[kMT][kNT][4],
                                           const char* const (&rows)[2 * kMT], unsigned tile,
                                           int qbase, int lane) const {
    const int tstride = tile_stride();
    const unsigned b_lo = memex::b_lane_addr(tile, tstride, qbase, lane);
    const unsigned b_hi = b_lo + part_bytes();
    // Packed bytes 4c .. 4c + 3 of each half of a k-step.
    const uint32_t* a[2 * kMT];
#pragma unroll
    for (int t = 0; t < 2 * kMT; ++t) a[t] = reinterpret_cast<const uint32_t*>(rows[t]) + (lane & 3);
#pragma unroll 2
    for (int k0 = 0; k0 < d2; k0 += 32) {
      const int w = k0 / 4;
      uint32_t lo[kMT][4], hi[kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const uint32_t packed[4] = {a[2 * t][w], a[2 * t + 1][w], a[2 * t][w + 4],
                                    a[2 * t + 1][w + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b8 = __vadd4(packed[i], 0x08080808u);
          hi[t][i] = unpack_hi(b8);
          lo[t][i] = __vsub4(b8 & 0x0f0f0f0fu, 0x08080808u);
        }
      }
      uint32_t bl[kNT / 2][4], bh[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        memex::ldmatrix_x4(bl[j], b_lo + j * 16 * tstride + k0);
        memex::ldmatrix_x4(bh[j], b_hi + j * 16 * tstride + k0);
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          memex::mma_s8(acc[t][2 * j], lo[t], bl[j][0], bl[j][1]);
          memex::mma_s8(acc[t][2 * j + 1], lo[t], bl[j][2], bl[j][3]);
          memex::mma_s8(acc[t][2 * j], hi[t], bh[j][0], bh[j][1]);
          memex::mma_s8(acc[t][2 * j + 1], hi[t], bh[j][2], bh[j][3]);
        }
    }
  }
};

// d += a * b for one 16 x 8 tile, k = 16: f16 in, f32 accumulate.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bytes n0 .. n3 of w as two f16 pairs (n0 - off, n1 - off) and (n2 -
// off, n3 - off), where `bias` holds the f16 1,024 + off twice: a byte
// under the high byte 0x64 is the f16 1,024 + n, and the difference of two
// integers below 2,048 is exact.
__device__ __forceinline__ void bytes_to_f16x2(uint32_t w, uint32_t bias, uint32_t& p01,
                                               uint32_t& p23) {
  const uint32_t u01 = __byte_perm(w, 0x64646464u, 0x4140);
  const uint32_t u23 = __byte_perm(w, 0x64646464u, 0x4342);
  const __half2 b = *reinterpret_cast<const __half2*>(&bias);
  const __half2 h01 = __hsub2(*reinterpret_cast<const __half2*>(&u01), b);
  const __half2 h23 = __hsub2(*reinterpret_cast<const __half2*>(&u23), b);
  p01 = *reinterpret_cast<const uint32_t*>(&h01);
  p23 = *reinterpret_cast<const uint32_t*>(&h23);
}

// Deferred mode: the tensor-core body's f16 product of
// b against in1 and of hi against in2. A k-step is 16 packed bytes, of
// which a lane holds one word a step: bytes 4c .. 4c + 3, as the fragment's
// pairs (4c, 4c + 1) and (4c + 2, 4c + 3). So a tile row holds the query's
// in1 values, then its in2 values, each group of 16 in the order 0 1 4 5 8
// 9 12 13, 2 3 6 7 10 11 14 15, which is where ldmatrix then finds them for
// those pairs.
struct DeferredMmaOp {
  using Acc = float;
  static constexpr int kTail = 80;
  static constexpr int kMaxRowBytes = kMaxDim / 2;
  __host__ __device__ static constexpr int max_tile_bytes(int tq) {
    return tq * (2 * kMaxDim + 16);
  }
  const float* in1;  // [n_q, d2] float32
  const float* in2;  // [n_q, d2]
  const void* db;    // [n_rows, d2] packed rows
  int d2;

  __host__ __device__ int row_bytes() const { return d2; }
  __host__ __device__ int tile_stride() const { return 4 * d2 + 16; }
  __host__ __device__ int tile_bytes(int tq) const { return tq * tile_stride(); }

  __device__ __forceinline__ void stage_tile(char* tile, int q0, int nq, int tq) const {
    const int pairs = d2 / 2;  // f16 pairs a query an operand
    const int tstride = tile_stride();
    for (int t = threadIdx.x; t < tq * d2; t += blockDim.x) {
      const int qq = t / d2;
      const int p = t - qq * d2;      // pair p of the row's 2 * pairs
      const int pp = p % pairs;       // ... and of its operand
      const int in_group = pp % 8;    // pair of its group of 16 values
      const int k = 16 * (pp / 8) + (in_group < 4 ? 4 * in_group : 4 * (in_group - 4) + 2);
      float2 v = make_float2(0.f, 0.f);
      if (qq < nq)
        v = *reinterpret_cast<const float2*>((p < pairs ? in1 : in2) + (long long)(q0 + qq) * d2 + k);
      *reinterpret_cast<__half2*>(tile + qq * tstride + 4 * p) = __floats2half2_rn(v.x, v.y);
    }
  }

  template <int kNT, int kMT>
  __device__ __forceinline__ void products(float (&acc)[kMT][kNT][4],
                                           const char* const (&rows)[2 * kMT], unsigned tile,
                                           int qbase, int lane) const {
    const int tstride = tile_stride();
    const unsigned b_1 = memex::b_lane_addr(tile, tstride, qbase, lane);
    const unsigned b_2 = b_1 + 2 * d2;
    const uint32_t* a[2 * kMT];
#pragma unroll
    for (int t = 0; t < 2 * kMT; ++t) a[t] = reinterpret_cast<const uint32_t*>(rows[t]) + (lane & 3);
#pragma unroll 2
    for (int k0 = 0; k0 < d2; k0 += 16) {
      uint32_t ab[kMT][4], ah[kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const uint32_t w0 = a[2 * t][k0 / 4], w8 = a[2 * t + 1][k0 / 4];
        // b + 128 and hi + 8 as bytes, then less 1,152 and 1,032.
        bytes_to_f16x2(w0 ^ 0x80808080u, 0x64806480u, ab[t][0], ab[t][2]);
        bytes_to_f16x2(w8 ^ 0x80808080u, 0x64806480u, ab[t][1], ab[t][3]);
        bytes_to_f16x2(((__vadd4(w0, 0x08080808u) >> 4) & 0x0f0f0f0fu) ^ 0x08080808u,
                       0x64086408u, ah[t][0], ah[t][2]);
        bytes_to_f16x2(((__vadd4(w8, 0x08080808u) >> 4) & 0x0f0f0f0fu) ^ 0x08080808u,
                       0x64086408u, ah[t][1], ah[t][3]);
      }
      uint32_t b1[kNT / 2][4], b2[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        memex::ldmatrix_x4(b1[j], b_1 + j * 16 * tstride + 2 * k0);
        memex::ldmatrix_x4(b2[j], b_2 + j * 16 * tstride + 2 * k0);
      }
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          mma_f16(acc[t][2 * j], ab[t], b1[j][0], b1[j][1]);
          mma_f16(acc[t][2 * j + 1], ab[t], b1[j][2], b1[j][3]);
          mma_f16(acc[t][2 * j], ah[t], b2[j][0], b2[j][1]);
          mma_f16(acc[t][2 * j + 1], ah[t], b2[j][2], b2[j][3]);
        }
    }
  }
};

// The fewest n-tiles a warp that hold the batch, up to 64 queries a warp;
// past that, two groups of 64 on warps of their own. Groups of 32 steps (two
// m-tiles) where the registers allow: with 17 warps a block a thread has 120,
// and 2 x 8 n-tiles of accumulators spill. Measured at 1M x 384: at 32
// queries two warps of 16 were slower than one of 32, at 64 two of 32 slower
// than one of 64, at 128 one of 128 slower than two of 64.
template <class MmaOp>
cudaError_t launch(const MmaOp& mma, const memex::ScanArgs& a, const memex::FlatWalk& walk,
                   bool keep2, cudaStream_t s) {
  if (a.n_q <= 16) return memex::launch_mma_flags<MmaOp, kSlots, 2, 1, 2>(mma, walk, a, keep2, s);
  if (a.n_q <= 32) return memex::launch_mma_flags<MmaOp, kSlots, 4, 1, 2>(mma, walk, a, keep2, s);
  if (a.n_q <= 64) return memex::launch_mma_flags<MmaOp, kSlots, 8, 1, 2>(mma, walk, a, keep2, s);
  return memex::launch_mma_flags<MmaOp, kSlots, 8, 2, 1>(mma, walk, a, keep2, s);
}

// The scan's query operands from float32 queries [n_q, d], one block a
// query, in the float32 arithmetic of the wrapper's plain version: scale =
// max(|q|_max, 1e-12) * f32(1 / 127), code = clamp(rint(q / scale), -127,
// 127); shift mode takes the codes' halves as int8, deferred mode in1 = lo
// and in2 = bf16(hi - 16 lo) (to nearest even) as float32.
constexpr int kPrepThreads = 128;
template <bool kDeferred>
__global__ void __launch_bounds__(kPrepThreads)
query_operands_kernel(const float* q, void* qa, void* qb, int d) {
  __shared__ float warp_max[kPrepThreads / 32];
  const float* const row = q + (long long)blockIdx.x * d;
  float m = 0.f;
  for (int i = threadIdx.x; i < d; i += kPrepThreads) m = fmaxf(m, fabsf(row[i]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kPrepThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  const float scale = __fmul_rn(fmaxf(m, 1e-12f), static_cast<float>(1.0 / 127.0));
  const int d2 = d / 2;
  for (int i = threadIdx.x; i < d2; i += kPrepThreads) {
    const float lo = fminf(fmaxf(rintf(__fdiv_rn(row[i], scale)), -127.f), 127.f);
    const float hi = fminf(fmaxf(rintf(__fdiv_rn(row[i + d2], scale)), -127.f), 127.f);
    const long long o = (long long)blockIdx.x * d2 + i;
    if (kDeferred) {
      static_cast<float*>(qa)[o] = lo;
      static_cast<float*>(qb)[o] = memex::round_bf16(hi - 16.f * lo);
    } else {
      static_cast<signed char*>(qa)[o] = static_cast<signed char>(lo);
      static_cast<signed char*>(qb)[o] = static_cast<signed char>(hi);
    }
  }
}

}  // namespace

extern "C" {

// The largest row dim the int4 kernel takes; the Python wrapper checks it.
int memex_fused_topk_int4q_max_dim() { return kMaxDim; }

// qa/qb: shift mode int8 [n_q, d/2] query halves (q8[:, :d/2], q8[:, d/2:]);
// deferred mode float32 [n_q, d/2] in1 and in2. db_p [n_rows, d/2] packed
// int8; scales8 [n_rows] f32, multiplied by scale_mul (127/7 as float32);
// alive [n_rows] f32 or null; out_v/out_i [n_q, n_slots] (and out_v2/out_i2
// when keep2). Columns >= limit = min(count, n_rows) are masked. Returns the
// launch's cudaError_t (0 on success).
int memex_fused_topk_int4q(const void* qa, const void* qb, const void* db_p,
                           const float* scales8, float scale_mul, const float* alive,
                           float* out_v, int* out_i, float* out_v2, int* out_i2, int n_q,
                           int d, int n_slots, long long limit, int deferred, int keep2,
                           void* stream) {
  // Packed rows stream in 16-byte copies: d / 2 must be a multiple of 16.
  if (n_q <= 0 || d <= 0 || d % 32 || d > kMaxDim || n_slots <= 0 || n_slots % kSlots)
    return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{scales8, scale_mul, alive, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const memex::FlatWalk walk{limit, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deferred) {
    const float* in1 = static_cast<const float*>(qa);
    const float* in2 = static_cast<const float*>(qb);
    return (int)launch(DeferredMmaOp{in1, in2, db_p, d / 2}, a, walk, keep2 != 0, s);
  }
  const char* q_lo = static_cast<const char*>(qa);
  const char* q_hi = static_cast<const char*>(qb);
  return (int)launch(ShiftMmaOp{q_lo, q_hi, db_p, d / 2}, a, walk, keep2 != 0, s);
}

// The scan's query operands qa, qb (as memex_fused_topk_int4q takes them,
// [n_q, d/2] each) from float32 queries q [n_q, d], d even. Returns the
// launch's cudaError_t.
int memex_int4_query_operands(const float* q, void* qa, void* qb, int n_q, int d, int deferred,
                              void* stream) {
  if (n_q <= 0 || d <= 0 || d % 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deferred)
    query_operands_kernel<true><<<n_q, kPrepThreads, 0, s>>>(q, qa, qb, d);
  else
    query_operands_kernel<false><<<n_q, kPrepThreads, 0, s>>>(q, qa, qb, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
