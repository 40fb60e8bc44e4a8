// Fused score + slot-bank fold over int8 rows (Hopper, sm_90a): the int8
// flat tier's scans.
//
// K2 replaces memex_tpu/ops/fused_topk.py::_fused_kernel_int8q: int8
// queries (quantized by the wrapper) against int8 rows, an exact s8 x s8
// dot in int32, one rounding to float32, times the row scale. The wrapper
// folds the query's own scale onto the k winners afterwards.
// K3 replaces memex_tpu/ops/fused_topk.py::_fused_kernel_int8: float32
// queries rounded to bf16 against int8 rows (exact as floats), FP32 FMA
// accumulation, times the row scale; single-winner fold only.
// Both mask columns at or past `count` and dead rows, and fold column c
// into slot c mod S as _fold_chunks does (slot_bank.cuh).
//
// What bounds them: HBM bytes, N * (D + 4) per 32-query tile (0.4 GB at
// 1M x 384), against 2 * Q * N * D integer or float operations -- below
// the card's ridge for Q <= 128 -- and, with one warp per slot, the
// warps in flight: S = 512 slots (K2 on the flat index) is 512 warps per
// 32 queries, about 4 per SM. The slot walk (slot_bank.cuh) therefore
// streams each warp's rows through a cp.async ring in shared memory, 8
// rows in flight per warp; a row is 384 contiguous bytes (24 16-byte
// copies). Lane l reads words l, l + 32, l + 64 of the row. K2's dot is
// `__dp4a` (four s8 products and an add per instruction) against the
// query tile in shared memory, kept as 4-byte words; K3 reads its tile as
// float4 and issues four FMAs per word. Partial sums are transpose-reduced
// in int32 (K2: exact, since |raw| <= 384 * 127 * 127 < 2^24, so the one
// rounding is the final int-to-float) or float32 (K3).

#include "slot_bank.cuh"

namespace {

constexpr int kWords = 3;                 // 4-byte row words per lane
constexpr int kTileWords = 32 * kWords;    // words per query in a tile (zero past d / 4)
constexpr int kMaxDim = 4 * kTileWords;    // 384

struct RowWords {
  uint32_t w[kWords];
};

// K2: int8 query tile as words, __dp4a into int32.
struct Int8qOp {
  using Row = RowWords;
  using Acc = int;
  const uint32_t* q;  // [n_q, wpr] int8 queries as words
  const void* db;     // [n_rows, d] int8 rows
  int wpr;            // words per row: d / 4

  __host__ __device__ int row_bytes() const { return 4 * wpr; }
  __host__ __device__ int tile_bytes(int kT) const { return 4 * kT * kTileWords; }

  template <int kT>
  __device__ void stage(char* tile, int q0, int nq) const {
    memex::stage_tile<kT>(reinterpret_cast<uint32_t*>(tile), q, wpr, kTileWords, q0, nq, 0u);
  }

  __device__ __forceinline__ void read(const char* st, int lane, Row& r) const {
    memex::read_words(st, wpr, lane, r.w);
  }

  template <int kT>
  __device__ __forceinline__ void partial(const Row& r, const char* tile, int lane,
                                          int (&part)[kT]) const {
    const uint32_t* qs = reinterpret_cast<const uint32_t*>(tile) + lane;
#pragma unroll
    for (int qq = 0; qq < kT; ++qq) {
      int acc = 0;
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        acc = __dp4a(static_cast<int>(r.w[j]), static_cast<int>(qs[qq * kTileWords + 32 * j]), acc);
      part[qq] = acc;
    }
  }
};

// K3: float32 queries rounded to bf16 at staging, float4 tile, FP32 FMA.
using Int8Op = memex::FloatTileOp<memex::Int8x4, true>;
static_assert(Int8Op::kMaxDim == kMaxDim, "K2 and K3 take the same dims");

// Rows stream in 16-byte copies: d must be a multiple of 16.
bool bad_shape(int n_q, int d, int n_slots) {
  return n_q <= 0 || d <= 0 || d % 16 || d > kMaxDim || n_slots <= 0 ||
         n_slots % memex::kScanWarps;
}

}  // namespace

extern "C" {

// The largest row dim the int8 kernels take; the Python wrapper checks it.
int memex_fused_topk_int8_max_dim() { return kMaxDim; }

// K2. q8 [n_q, d] int8; db [n_rows, d] int8; scales [n_rows] f32; alive
// [n_rows] f32 or null; out_v/out_i [n_q, n_slots] (and out_v2/out_i2 when
// keep2). Columns >= limit = min(count, n_rows) are masked. Returns the
// launch's cudaError_t (0 on success).
int memex_fused_topk_int8q(const void* q8, const void* db, const float* scales,
                           const float* alive, float* out_v, int* out_i, float* out_v2,
                           int* out_i2, int n_q, int d, int n_slots, long long limit,
                           int keep2, void* stream) {
  if (bad_shape(n_q, d, n_slots)) return (int)cudaErrorInvalidValue;
  const Int8qOp op{static_cast<const uint32_t*>(q8), db, d / 4};
  const memex::ScanArgs a{scales, 1.f, alive, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  return (int)memex::launch_scan_flags(op, memex::FlatWalk{limit, n_slots}, a, keep2 != 0,
                                       static_cast<cudaStream_t>(stream));
}

// K3. q [n_q, d] f32 (rounded to bf16 in the kernel); the rest as K2,
// without keep2.
int memex_fused_topk_int8(const float* q, const void* db, const float* scales,
                          const float* alive, float* out_v, int* out_i, int n_q, int d,
                          int n_slots, long long limit, void* stream) {
  if (bad_shape(n_q, d, n_slots)) return (int)cudaErrorInvalidValue;
  const Int8Op op{reinterpret_cast<const float4*>(q), db, d / 4};
  const memex::ScanArgs a{scales, 1.f, alive, out_v, out_i, nullptr, nullptr, n_q, n_slots};
  return (int)memex::launch_scan_flags(op, memex::FlatWalk{limit, n_slots}, a, false,
                                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
