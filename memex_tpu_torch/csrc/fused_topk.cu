// Fused score + slot-bank fold for the flat index scan (Hopper, sm_90a).
//
// Replaces memex_tpu/ops/fused_topk.py::_fused_kernel (with _fold_chunks):
// scores Q queries against N rows and, without writing the [Q, N] score
// matrix anywhere, folds column c into slot c mod S of a per-query bank,
// keeping the slot's best value (keep2: its best two). Columns at or past
// `count`, and rows whose `alive` entry is 0, never enter a slot. The
// caller sorts the [Q, S] (keep2: [Q, 2S]) bank to the top-k.
//
// What bounds it: HBM bytes. Every row is read once per 32-query tile,
// N*D*4 bytes for f32 rows and N*D*2 for bf16 (1.5 GB / 0.75 GB at
// 1M x 384), against 2*Q*N*D flops -- far below the card's flop/byte
// ridge for Q <= 128. The design therefore spends its effort on keeping
// loads in flight and reading nothing twice:
//   - one warp owns one slot and walks that slot's columns s, s+S, s+2S, ...
//     in ascending order, so the fold needs no cross-block merge and its
//     tie rule is the TPU kernel's exactly (strict '>': the earlier column
//     wins, fused_topk.py:64);
//   - a row is S columns away from the warp's previous one, but the 8 warps
//     of a block own 8 neighbouring slots, so each step of a block reads 8
//     contiguous rows; within a warp, lane l reads the (l + 32 j)-th pair of
//     elements, so a warp's load is 256 contiguous bytes per j (coalesced);
//   - each warp issues the loads of its next row (and its `alive` entry)
//     before scoring the current one, and converts a row's registers only
//     when it is scored, so the loads stay in flight through the compute.
//     Deeper register rings were measured slower on the H100 (register
//     pressure and spills at 128 registers), so the prefetch is one row;
//   - the query tile (32 queries, already bf16-rounded unless `exact`)
//     sits in shared memory; each lane forms partial dots for all 32
//     queries over its slice of D, and a butterfly transpose-reduce (31
//     shuffles for 32 sums) leaves lane l holding the score of query l,
//     which lane l then folds into the (query l, slot) pair it owns;
//   - columns past min(count, N) are never read: a masked column cannot
//     change a slot (-1e30 never beats the -1e30 initial value), so the
//     walk stops at the fill level instead of streaming empty capacity.
// Precision: non-exact mode rounds both inputs to bf16 (round to nearest
// even) and accumulates products in FP32 FMA, as the TPU kernel's bf16 MXU
// inputs with f32 accumulation; `exact` keeps FP32 inputs and FP32 FMA
// throughout. Tensor cores are not used, so TF32 never enters.

#include "slot_bank.cuh"

namespace {

using memex::kQT;
using memex::round_bf16;
using memex::SlotBank;
using memex::transpose_reduce;

constexpr int kWarps = 8;          // slots per block: one per warp
constexpr int kPairs = 6;          // element pairs per lane
constexpr int kMaxDim = 64 * kPairs;  // largest row dim: 384 (MiniLM)

template <bool kBf16Rows>
struct RowTraits;
template <>
struct RowTraits<false> {
  using Raw = float2;  // two f32 elements
};
template <>
struct RowTraits<true> {
  using Raw = __nv_bfloat162;  // two bf16 elements
};

// Issue the loads of one row's slice for this lane; the registers are
// converted only when the row is scored, so the loads stay in flight.
template <bool kBf16Rows>
__device__ __forceinline__ void load_row(
    const typename RowTraits<kBf16Rows>::Raw* __restrict__ db, long long row,
    int half_d, int lane, typename RowTraits<kBf16Rows>::Raw (&r)[kPairs]) {
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = lane + 32 * j;
    if (p < half_d) r[j] = db[row * half_d + p];
  }
}

template <bool kBf16Rows, bool kExact>
__device__ __forceinline__ float2 to_f32(typename RowTraits<kBf16Rows>::Raw v) {
  if constexpr (kBf16Rows) {
    return __bfloat1622float2(v);
  } else {
    if (!kExact) {
      v.x = round_bf16(v.x);
      v.y = round_bf16(v.y);
    }
    return v;
  }
}

template <bool kBf16Rows, bool kExact, bool kKeep2, bool kAlive>
__global__ void __launch_bounds__(kWarps * 32, 2)
fused_topk_kernel(const float* __restrict__ q, const void* __restrict__ db_raw,
                  const float* __restrict__ alive, float* __restrict__ out_v,
                  int* __restrict__ out_i, float* __restrict__ out_v2,
                  int* __restrict__ out_i2, int n_q, int d, int n_slots,
                  long long limit) {
  using Raw = typename RowTraits<kBf16Rows>::Raw;
  const Raw* __restrict__ db = static_cast<const Raw*>(db_raw);
  extern __shared__ float2 qs[];  // [kQT][d / 2]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kWarps + warp;
  const int q0 = blockIdx.y * kQT;
  const int nq = min(kQT, n_q - q0);
  const int half_d = d / 2;

  // Stage the query tile; rows past nq are zero and never written out.
  for (int t = threadIdx.x; t < kQT * half_d; t += blockDim.x) {
    const int qq = t / half_d;
    const int p = t - qq * half_d;
    float2 v = make_float2(0.f, 0.f);
    if (qq < nq) {
      v = reinterpret_cast<const float2*>(q)[(long long)(q0 + qq) * half_d + p];
      if (!kExact) {
        v.x = round_bf16(v.x);
        v.y = round_bf16(v.y);
      }
    }
    qs[t] = v;
  }
  __syncthreads();

  SlotBank<kKeep2> bank;

  // `next` holds the raw registers of the warp's next column.
  Raw next[kPairs];
  float next_alive = 1.f;
  if (slot < limit) {
    load_row<kBf16Rows>(db, slot, half_d, lane, next);
    if (kAlive) next_alive = alive[slot];
  }
  for (long long col = slot; col < limit; col += n_slots) {
    float2 row[kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) row[j] = to_f32<kBf16Rows, kExact>(next[j]);
    const bool live = !kAlive || next_alive > 0.f;
    if (col + n_slots < limit) {
      load_row<kBf16Rows>(db, col + n_slots, half_d, lane, next);
      if (kAlive) next_alive = alive[col + n_slots];
    }
    // Warp-uniform: a dead row is skipped whole, as a -1e30 score is a
    // no-op in the fold.
    if (!live) continue;
    float part[kQT];
#pragma unroll
    for (int qq = 0; qq < kQT; ++qq) {
      float acc = 0.f;
      if (qq < nq) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int p = lane + 32 * j;
          if (p < half_d) {
            const float2 qv = qs[qq * half_d + p];
            acc = fmaf(row[j].x, qv.x, acc);
            acc = fmaf(row[j].y, qv.y, acc);
          }
        }
      }
      part[qq] = acc;
    }
    transpose_reduce<kQT / 2>(part, lane);
    // _fold_chunks: take = s > best; the loser of that duel competes for
    // the second place (keep2).
    bank.fold(part[0], static_cast<int>(col));
  }

  if (lane < nq)
    bank.store(out_v, out_i, out_v2, out_i2, (long long)(q0 + lane) * n_slots + slot);
}

struct Args {
  const float* q;
  const void* db;
  const float* alive;
  float* v;
  int* i;
  float* v2;
  int* i2;
  int n_q, d, n_slots;
  long long limit;
  cudaStream_t stream;
};

template <bool kBf16Rows, bool kExact, bool kKeep2, bool kAlive>
cudaError_t launch(const Args& a) {
  auto kernel = fused_topk_kernel<kBf16Rows, kExact, kKeep2, kAlive>;
  const size_t smem = sizeof(float) * kQT * a.d;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_slots / kWarps, (a.n_q + kQT - 1) / kQT);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      a.q, a.db, a.alive, a.v, a.i, a.v2, a.i2, a.n_q, a.d, a.n_slots, a.limit);
  return cudaGetLastError();
}

template <bool kBf16Rows, bool kExact>
cudaError_t pick_flags(const Args& a, bool keep2) {
  if (keep2)
    return a.alive ? launch<kBf16Rows, kExact, true, true>(a)
                   : launch<kBf16Rows, kExact, true, false>(a);
  return a.alive ? launch<kBf16Rows, kExact, false, true>(a)
                 : launch<kBf16Rows, kExact, false, false>(a);
}

}  // namespace

extern "C" {

// The largest row dim the kernel takes; the Python wrapper checks it.
int memex_fused_topk_max_dim() { return kMaxDim; }

// q [n_q, d] f32; db [n_rows, d] f32 (db_bf16 = 0) or bf16 (db_bf16 = 1);
// alive [n_rows] f32 or null; out_v/out_i [n_q, n_slots]; out_v2/out_i2
// likewise when keep2, else unused. Columns >= limit = min(count, n_rows)
// are masked. Returns the launch's cudaError_t (0 on success).
int memex_fused_topk(const float* q, const void* db, int db_bf16,
                     const float* alive, float* out_v, int* out_i,
                     float* out_v2, int* out_i2, int n_q, int d, int n_slots,
                     long long limit, int exact, int keep2, void* stream) {
  if (n_q <= 0 || d <= 0 || d % 2 || d > kMaxDim || n_slots <= 0 ||
      n_slots % kWarps)
    return (int)cudaErrorInvalidValue;
  const Args a{q, db, alive, out_v, out_i, out_v2, out_i2, n_q, d, n_slots,
               limit, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (db_bf16)
    err = pick_flags<true, false>(a, keep2 != 0);
  else if (exact)
    err = pick_flags<false, true>(a, keep2 != 0);
  else
    err = pick_flags<false, false>(a, keep2 != 0);
  return (int)err;
}

}  // extern "C"
