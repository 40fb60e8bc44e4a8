// Fused score + slot-bank fold over int8 rows (Hopper, sm_90a): the int8
// flat tier's scans.
//
// K2 replaces memex_tpu/ops/fused_topk.py::_fused_kernel_int8q: int8
// queries (quantized by the wrapper) against int8 rows, an exact s8 x s8
// dot in int32, one rounding to float32, times the row scale. The wrapper
// folds the query's own scale onto the k winners afterwards.
// K3 replaces memex_tpu/ops/fused_topk.py::_fused_kernel_int8: float32
// queries rounded to bf16 against int8 rows (exact as bf16), f32
// accumulation, times the row scale; single-winner fold only.
// Both mask columns at or past `count` and dead rows, and fold column c
// into slot c mod S as _fold_chunks does (slot_bank.cuh).
//
// What bounds them: HBM bytes, N * (D + 4) per batch (0.4 GB at 1M x 384,
// 0.12 ms), against 2 * Q * N * D integer or float operations -- below the
// card's ridge for Q <= 128 -- and, with one slot per warp, the warps in
// flight: S = 512 slots (K2 on the flat index) is 512 slots' walks, about 4
// an SM.
// K2 runs slot_bank.cuh's tensor-core body with an integer product at every
// batch size: mma.sync m16n8k32 s8 x s8 -> s32. A is a warp's 32 steps of
// its slot's rows, read from the ring as raw 32-bit words (four codes along
// k: no conversion); B is the int8 query tile, staged once a block as bytes
// and read with ldmatrix. A block holds 4 slots (128 blocks at S = 512, one
// an SM) and, past 64 queries, two warps a slot, each on its own queries.
// The dot is exact (|raw| <= 384 * 127 * 127 < 2^24), so the one rounding is
// the final int-to-float, and the bank is bit-equal to the plain version's.
// K3 runs the same body with K5's int8 product (slot_bank.cuh's
// MmaTileOp<Int8Rows>) on the flat walk, at every batch size: the codes
// become bf16 pairs by an exponent trick (no conversion pipe), the queries a
// bf16 tile of up to 128, mma.sync m16n8k16 with f32 accumulate; 8 slots a
// block (128 blocks at S = 1,024), one warp a slot.
// The sum order is the tensor core's, so K3 agrees with its plain version
// within float32 rounding of a 384-term sum, not bit for bit.

#include "slot_bank.cuh"

namespace {

constexpr int kMaxDim = 384;  // the widest row both kernels take

// K2: the tensor-core body's s8 product. A k-step is 32 codes; a d that is
// only a multiple of 16 ends on the tile's zero bytes, and whatever the A
// words past the row hold (the next slot's row or the stage's tail) is
// multiplied by zero.
struct Int8qMmaOp {
  using Acc = int;
  static constexpr int kFolds = 1;
  static constexpr int kSlots = 4;  // a block's slots: 128 blocks at S = 512
  static constexpr int kTail = 48;
  static constexpr int kMaxRowBytes = kMaxDim;
  __host__ __device__ static constexpr int max_tile_bytes(int tq) {
    return tq * (memex::round_up(kMaxDim, 32) + 16);
  }
  const char* q8;  // [n_q, d] int8 queries
  const void* db;  // [n_rows, d] int8 rows
  int d;

  __host__ __device__ int row_bytes() const { return d; }
  __host__ __device__ int tile_stride() const { return memex::round_up(d, 32) + 16; }
  __host__ __device__ int tile_bytes(int tq) const { return tq * tile_stride(); }

  __device__ __forceinline__ void stage_tile(char* tile, int q0, int nq, int tq) const {
    memex::stage_s8_tile(tile, tile_stride(), q8, d, memex::round_up(d, 32), q0, nq, tq);
  }

  template <int kNT, int kMT>
  __device__ __forceinline__ void products(int (&acc)[kMT][kNT][4],
                                           const char* const (&rows)[2 * kMT], unsigned tile,
                                           int qbase, int lane) const {
    const int tstride = tile_stride();
    const unsigned b_lane = memex::b_lane_addr(tile, tstride, qbase, lane);
    // Codes 4c .. 4c + 3 of each half of a k-step.
    const uint32_t* a[2 * kMT];
#pragma unroll
    for (int t = 0; t < 2 * kMT; ++t) a[t] = reinterpret_cast<const uint32_t*>(rows[t]) + (lane & 3);
#pragma unroll 2
    for (int k0 = 0; k0 < d; k0 += 32) {
      const int w = k0 / 4;
      uint32_t af[kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        af[t][0] = a[2 * t][w];
        af[t][1] = a[2 * t + 1][w];
        af[t][2] = a[2 * t][w + 4];
        af[t][3] = a[2 * t + 1][w + 4];
      }
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        memex::ldmatrix_x4(bf[j], b_lane + j * 16 * tstride + k0);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          memex::mma_s8(acc[t][2 * j], af[t], bf[j][0], bf[j][1]);
          memex::mma_s8(acc[t][2 * j + 1], af[t], bf[j][2], bf[j][3]);
        }
    }
  }
};

// K3: float32 queries rounded to bf16 at staging, int8 codes as bf16 pairs.
using Int8Op = memex::MmaTileOp<memex::Int8Rows>;
static_assert(Int8Op::kMaxRowBytes == kMaxDim, "K2 and K3 take the same dims");

// Rows stream in 16-byte copies: d must be a multiple of 16; a block owns
// `block_slots` slots of the bank.
bool bad_shape(int n_q, int d, int n_slots, int block_slots) {
  return n_q <= 0 || d <= 0 || d % 16 || d > kMaxDim || n_slots <= 0 || n_slots % block_slots;
}

// K3 has no keep2: only the single-winner fold is built. One warp a slot
// holds the whole batch in kNT n-tiles, in 16-step groups.
template <int kNT>
cudaError_t launch_k3(const Int8Op& op, const memex::FlatWalk& walk, const memex::ScanArgs& a,
                      cudaStream_t s) {
  constexpr int kW = memex::Int8Rows::kWarps;
  return a.alive ? memex::launch_mma_scan<Int8Op, kW, kNT, 1, 1, memex::FlatWalk, false, true>(
                       op, walk, a, s)
                 : memex::launch_mma_scan<Int8Op, kW, kNT, 1, 1, memex::FlatWalk, false, false>(
                       op, walk, a, s);
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
  if (bad_shape(n_q, d, n_slots, Int8qMmaOp::kSlots)) return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{scales, 1.f, alive, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const memex::FlatWalk walk{limit, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k2 = keep2 != 0;
  // The fewest n-tiles a warp that hold the batch, up to 64 queries a
  // warp; past that, two groups of 64 on warps of their own. Measured at 1M
  // x 384: at 32 queries two warps of 16 were slower than one of 32, at 128
  // four of 32 or one of 128 slower than two of 64; a lone query on a
  // 16-query tile took 0.18 ms where the SIMT one-query walk took 0.83.
  using Op = Int8qMmaOp;
  constexpr int kW = Op::kSlots;
  const Op op{static_cast<const char*>(q8), db, d};
  if (n_q <= 16) return (int)memex::launch_mma_flags<Op, kW, 2, 1, 2>(op, walk, a, k2, s);
  if (n_q <= 32) return (int)memex::launch_mma_flags<Op, kW, 4, 1, 2>(op, walk, a, k2, s);
  if (n_q <= 64) return (int)memex::launch_mma_flags<Op, kW, 8, 1, 2>(op, walk, a, k2, s);
  return (int)memex::launch_mma_flags<Op, kW, 8, 2, 2>(op, walk, a, k2, s);
}

// K3. q [n_q, d] f32 (rounded to bf16 in the kernel); the rest as K2,
// without keep2; n_slots a multiple of 8.
int memex_fused_topk_int8(const float* q, const void* db, const float* scales,
                          const float* alive, float* out_v, int* out_i, int n_q, int d,
                          int n_slots, long long limit, void* stream) {
  constexpr int kW = memex::Int8Rows::kWarps;
  if (bad_shape(n_q, d, n_slots, kW)) return (int)cudaErrorInvalidValue;
  const Int8Op op{q, db, d};
  const memex::ScanArgs a{scales, 1.f, alive, out_v, out_i, nullptr, nullptr, n_q, n_slots};
  const memex::FlatWalk walk{limit, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The fewest n-tiles that hold the batch, K5's shapes; a lone query runs
  // the 16-query tile too. Measured on an NVIDIA H100 80GB HBM3 at 700 W,
  // 1M x 384, S = 1,024: a lone query
  // 0.22-0.27 ms here against 0.51-0.57 on the SIMT one-query walk; groups
  // of 32 steps changed nothing up to 64 queries (0.27 and 0.33-0.35 ms
  // either way); at 128 queries one warp of 128 (0.49-0.50) beat two warps
  // of 64 (0.55-0.59), the reverse of K2, whose s8 products need no
  // conversion of the rows.
  if (n_q <= 16) return (int)launch_k3<2>(op, walk, a, s);
  if (n_q <= 32) return (int)launch_k3<4>(op, walk, a, s);
  if (n_q <= 64) return (int)launch_k3<8>(op, walk, a, s);
  return (int)launch_k3<16>(op, walk, a, s);
}

}  // extern "C"
