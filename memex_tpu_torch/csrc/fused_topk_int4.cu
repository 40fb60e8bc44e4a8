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
// What bounds it: HBM bytes, N * (D/2 + 4) per 32-query tile (0.2 GB at
// 1M x 384), and the unpack. The shift unpack is four byte-parallel
// operations per 4-byte word (__vadd4 / mask / __vsub4), done once per row
// per lane, not per query; the dots are __dp4a against the query halves
// held in shared memory as words. The deferred path converts a word's
// bytes and hi parts to floats once per row and reads a float4 tile per word.
// Rows stream through the cp.async ring of slot_bank.cuh, 8 in flight
// per warp (12 16-byte copies a row).

#include "slot_bank.cuh"

namespace {

constexpr int kWords = 2;                  // 4-byte packed-row words per lane
constexpr int kTileWords = 32 * kWords;     // words per query half in a tile
constexpr int kMaxHalf = 4 * kTileWords;    // largest D/2: 256
constexpr int kMaxDim = 384;                // the int8 tier's limit (its rerank rows)
static_assert(kMaxDim <= 2 * kMaxHalf, "a lane holds at most kWords packed words");

struct RowWords {
  uint32_t w[kWords];
};

// hi byte of each packed byte: t = b + 8 = 16 * hi + (lo + 8), lo + 8 in
// [1, 15], so bits 4..7 of t are hi mod 16; (n ^ 8) - 8 sign-extends them.
__device__ __forceinline__ uint32_t unpack_hi(uint32_t t) {
  return __vsub4(((t >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

// Shift mode: int8 query halves as words, two __dp4a per word.
struct ShiftOp {
  using Row = RowWords;
  using Acc = int;
  const uint32_t* q_lo;  // [n_q, wpr] int8 q8[:, :D/2] as words
  const uint32_t* q_hi;  // [n_q, wpr] int8 q8[:, D/2:] as words
  const void* db;        // [n_rows, d/2] packed rows
  int wpr;               // words per packed row: d / 8

  __host__ __device__ int row_bytes() const { return 4 * wpr; }
  __host__ __device__ int tile_bytes(int kT) const { return 2 * 4 * kT * kTileWords; }

  template <int kT>
  __device__ void stage(char* tile, int q0, int nq) const {
    uint32_t* lo = reinterpret_cast<uint32_t*>(tile);
    memex::stage_tile<kT>(lo, q_lo, wpr, kTileWords, q0, nq, 0u);
    memex::stage_tile<kT>(lo + kT * kTileWords, q_hi, wpr, kTileWords, q0, nq, 0u);
  }

  __device__ __forceinline__ void read(const char* st, int lane, Row& r) const {
    memex::read_words(st, wpr, lane, r.w);
  }

  template <int kT>
  __device__ __forceinline__ void partial(const Row& r, const char* tile, int lane,
                                          int (&part)[kT]) const {
    const uint32_t* qlo = reinterpret_cast<const uint32_t*>(tile) + lane;
    const uint32_t* qhi = qlo + kT * kTileWords;
    int lo[kWords], hi[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t t = __vadd4(r.w[j], 0x08080808u);
      hi[j] = static_cast<int>(unpack_hi(t));
      lo[j] = static_cast<int>(__vsub4(t & 0x0f0f0f0fu, 0x08080808u));
    }
#pragma unroll
    for (int qq = 0; qq < kT; ++qq) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int o = qq * kTileWords + 32 * j;
        acc = __dp4a(lo[j], static_cast<int>(qlo[o]), acc);
        acc = __dp4a(hi[j], static_cast<int>(qhi[o]), acc);
      }
      part[qq] = acc;
    }
  }
};

// Deferred mode: float4 tiles of in1 = bf16(q_lo) and in2 = bf16(q_hi -
// 16 q_lo) (both already rounded by the wrapper), FP32 FMA.
struct DeferredOp {
  using Row = RowWords;
  using Acc = float;
  const float4* in1;  // [n_q, wpr] float32, 4 per packed word
  const float4* in2;  // [n_q, wpr]
  const void* db;     // [n_rows, d/2] packed rows
  int wpr;

  __host__ __device__ int row_bytes() const { return 4 * wpr; }
  __host__ __device__ int tile_bytes(int kT) const { return 2 * 16 * kT * kTileWords; }

  template <int kT>
  __device__ void stage(char* tile, int q0, int nq) const {
    float4* a = reinterpret_cast<float4*>(tile);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    memex::stage_tile<kT>(a, in1, wpr, kTileWords, q0, nq, zero);
    memex::stage_tile<kT>(a + kT * kTileWords, in2, wpr, kTileWords, q0, nq, zero);
  }

  __device__ __forceinline__ void read(const char* st, int lane, Row& r) const {
    memex::read_words(st, wpr, lane, r.w);
  }

  template <int kT>
  __device__ __forceinline__ void partial(const Row& r, const char* tile, int lane,
                                          float (&part)[kT]) const {
    const float4* t1 = reinterpret_cast<const float4*>(tile) + lane;
    const float4* t2 = t1 + kT * kTileWords;
    float b[kWords][4], h[kWords][4];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t hw = unpack_hi(__vadd4(r.w[j], 0x08080808u));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b[j][k] = memex::byte_f32(r.w[j], k);
        h[j][k] = memex::byte_f32(hw, k);
      }
    }
#pragma unroll
    for (int qq = 0; qq < kT; ++qq) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const float4 x = t1[qq * kTileWords + 32 * j];
        const float4 y = t2[qq * kTileWords + 32 * j];
        acc = fmaf(b[j][0], x.x, acc);
        acc = fmaf(b[j][1], x.y, acc);
        acc = fmaf(b[j][2], x.z, acc);
        acc = fmaf(b[j][3], x.w, acc);
        acc = fmaf(h[j][0], y.x, acc);
        acc = fmaf(h[j][1], y.y, acc);
        acc = fmaf(h[j][2], y.z, acc);
        acc = fmaf(h[j][3], y.w, acc);
      }
      part[qq] = acc;
    }
  }
};

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
  if (n_q <= 0 || d <= 0 || d % 32 || d > kMaxDim || n_slots <= 0 ||
      n_slots % memex::kScanWarps)
    return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{scales8, scale_mul, alive, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const memex::FlatWalk walk{limit, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deferred) {
    const DeferredOp op{static_cast<const float4*>(qa), static_cast<const float4*>(qb), db_p, d / 8};
    return (int)memex::launch_scan_flags(op, walk, a, keep2 != 0, s);
  }
  const ShiftOp op{static_cast<const uint32_t*>(qa), static_cast<const uint32_t*>(qb), db_p, d / 8};
  return (int)memex::launch_scan_flags(op, walk, a, keep2 != 0, s);
}

}  // extern "C"
