// Pieces shared by the fused scan kernels (fused_topk*.cu): the warp's
// transpose-reduce and the per-slot fold of memex_tpu/ops/fused_topk.py's
// _fold_chunks, plus the slot walk of the quantized kernels.
//
// Every scan kernel gives one warp one slot s of the S-slot bank and one
// tile of queries (32; the quantized kernels take a single query alone).
// The warp walks the slot's columns s, s+S, s+2S, ... in ascending order,
// so its fold sees the columns in the TPU's order and keeps the TPU's tie
// rule (strict '>': the earlier column wins) without any merge across
// blocks. Lane l scores its slice of the row against every query of the
// tile; the transpose-reduce then leaves lane l holding the whole score of
// query l, which lane l folds into the (query l, slot) pair it owns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace memex {

constexpr float kNegInf = -1e30f;  // fused_topk.py NEG_INF
constexpr int kQT = 32;            // queries per block: one per lane

// Butterfly transpose-reduce over the warp: after the step with offset OFF,
// lane l holds half as many partial sums, for the queries whose index bits
// at and above OFF match l's. Started at OFF = N/2 for N partial sums, it
// leaves part[0] of lane l holding query (l mod N)'s sum over the N lanes
// of l's group; for N = 32 that is the full dot of query `lane`, with 31
// shuffles for 32 sums. Integer partials sum exactly.
template <int OFF, typename T, int N>
__device__ __forceinline__ void transpose_reduce(T (&part)[N], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const T send = upper ? part[i] : part[i + OFF];
    const T keep = upper ? part[i + OFF] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) transpose_reduce<OFF / 2>(part, lane);
}

// A tile of kT queries (kT a power of two <= 32): lane l ends with the full
// dot of query (l mod kT) in part[0]. The transpose-reduce sums within
// groups of kT lanes, then xor-shuffles sum across the groups: 31 shuffles
// for kT = 32, 5 for a single query.
template <int kT, typename T>
__device__ __forceinline__ void reduce_tile(T (&part)[kT], int lane) {
  if constexpr (kT > 1) transpose_reduce<kT / 2>(part, lane);
#pragma unroll
  for (int off = kT; off < 32; off *= 2) part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
}

// One (query, slot) accumulator of _fold_chunks: take = s > best; with
// keep2 the loser of that duel competes for second place.
template <bool kKeep2>
struct SlotBank {
  float best_v = kNegInf, second_v = kNegInf;
  int best_i = 0, second_i = 0;

  __device__ __forceinline__ void fold(float s, int c) {
    if (s > best_v) {
      if (kKeep2 && best_v > second_v) {
        second_v = best_v;
        second_i = best_i;
      }
      best_v = s;
      best_i = c;
    } else if (kKeep2 && s > second_v) {
      second_v = s;
      second_i = c;
    }
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, float* out_v2,
                                        int* out_i2, long long o) const {
    out_v[o] = best_v;
    out_i[o] = best_i;
    if (kKeep2) {
      out_v2[o] = second_v;
      out_i2[o] = second_i;
    }
  }
};

// Outputs and bounds of one quantized scan launch.
struct ScanArgs {
  const float* scales;  // [n_rows] row scales
  float scale_mul;      // score = raw * (scales[col] * scale_mul)
  const float* alive;   // [n_rows] or null
  float* v;
  int* i;
  float* v2;
  int* i2;
  int n_q, n_slots;
  long long limit;  // min(count, n_rows): columns at or past it are masked
};

// Slots per block of a quantized scan, and rows each warp keeps in flight.
// Measured on the H100 at 1M x 384 (bank times): 2 or 8 warps a block and
// 4 or 16 stages move no kernel by more than ~15%; 4 and 8 were best or
// within noise of it.
constexpr int kScanWarps = 4;
constexpr int kScanStages = 8;

// Asynchronous global -> shared copies (sm_80+): the copy engine, not the
// warp's registers, holds the rows in flight.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of one stage of a warp's ring: the row, then its scale and alive
// entries in a 16-byte tail.
__host__ __device__ constexpr int stage_bytes(int row_bytes) { return row_bytes + 16; }

// The slot walk of the quantized kernels, for a tile of kT queries (1 or
// 32). `Op` supplies the row type and the lane's partial dots:
//   Op::Row, Op::Acc, op.row_bytes() (a multiple of 16), op.db (the rows),
//   op.tile_bytes(kT) (a multiple of 16), op.stage<kT>(tile, q0, nq),
//   op.read(stage, lane, Row&), op.partial<kT>(const Row&, tile, lane, Acc (&)[kT]).
// The tile's rows past nq are zero, so the partial dots run unguarded over
// all kT queries (straight-line code the compiler can interleave); a
// single query gets its own one-query tile rather than 31 wasted ones.
// Each warp streams its slot's rows through a ring of kScanStages stages in
// shared memory with cp.async: the row c + kScanStages * S is requested as
// soon as row c has been read out of its stage, so kScanStages rows (with
// their scale and alive entries) are always in flight per warp, whatever
// the compiler does with registers.
template <class Op, int kT, bool kKeep2, bool kAlive>
__global__ void __launch_bounds__(kScanWarps * 32)
quant_scan_kernel(const Op op, const ScanArgs a) {
  extern __shared__ uint4 smem_raw[];
  char* const tile = reinterpret_cast<char*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = blockIdx.x * kScanWarps + warp;
  const int q0 = blockIdx.y * kT;
  const int nq = min(kT, a.n_q - q0);
  const int row_bytes = op.row_bytes();
  const int sbytes = stage_bytes(row_bytes);
  char* const ring = tile + op.tile_bytes(kT) + warp * kScanStages * sbytes;
  const char* const rows = static_cast<const char*>(op.db);

  // Request column `col` into stage `s` (nothing past the fill level); one
  // commit group per call, so the wait below counts stages.
  auto request = [&](int s, long long col) {
    if (col < a.limit) {
      char* dst = ring + s * sbytes;
      const char* src = rows + col * row_bytes;
      for (int c = lane; c < row_bytes / 16; c += 32) cp_async16(dst + 16 * c, src + 16 * c);
      if (lane == 31) cp_async4(dst + row_bytes, a.scales + col);
      if (kAlive && lane == 30) cp_async4(dst + row_bytes + 4, a.alive + col);
    }
    cp_async_commit();
  };

  for (int s = 0; s < kScanStages; ++s) request(s, slot + (long long)s * a.n_slots);
  op.template stage<kT>(tile, q0, nq);
  __syncthreads();

  SlotBank<kKeep2> bank;
  const long long step = (long long)kScanStages * a.n_slots;
  for (long long base = slot; base < a.limit; base += step) {
    for (int s = 0; s < kScanStages; ++s) {
      const long long col = base + (long long)s * a.n_slots;
      if (col >= a.limit) break;  // warp-uniform
      cp_async_wait<kScanStages - 1>();  // this lane's copies of the oldest stage landed
      __syncwarp();                      // ... and every other lane's
      const char* st = ring + s * sbytes;
      const float scale = *reinterpret_cast<const float*>(st + row_bytes);
      const bool live = !kAlive || *reinterpret_cast<const float*>(st + row_bytes + 4) > 0.f;
      typename Op::Row row;
      op.read(st, lane, row);
      __syncwarp();  // the stage is read out: refill it
      request(s, col + step);
      // Warp-uniform: a dead row is skipped whole, as a -1e30 score is a
      // no-op in the fold.
      if (!live) continue;
      typename Op::Acc part[kT];
      op.template partial<kT>(row, tile, lane, part);
      reduce_tile<kT>(part, lane);
      // One rounding of the exact dot (integer kernels), then the scale:
      // the TPU kernels' `raw.astype(f32) * scale`.
      bank.fold(static_cast<float>(part[0]) * (scale * a.scale_mul), static_cast<int>(col));
    }
  }
  cp_async_wait<0>();
  if (lane < nq) bank.store(a.v, a.i, a.v2, a.i2, (long long)(q0 + lane) * a.n_slots + slot);
}

template <class Op, int kT, bool kKeep2, bool kAlive>
cudaError_t launch_scan(const Op& op, const ScanArgs& a, cudaStream_t stream) {
  auto kernel = quant_scan_kernel<Op, kT, kKeep2, kAlive>;
  const size_t smem =
      op.tile_bytes(kT) + (size_t)kScanWarps * kScanStages * stage_bytes(op.row_bytes());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_slots / kScanWarps, (a.n_q + kT - 1) / kT);
  kernel<<<grid, kScanWarps * 32, smem, stream>>>(op, a);
  return cudaGetLastError();
}

template <class Op, int kT>
cudaError_t launch_scan_tile(const Op& op, const ScanArgs& a, bool keep2, cudaStream_t stream) {
  if (keep2)
    return a.alive ? launch_scan<Op, kT, true, true>(op, a, stream)
                   : launch_scan<Op, kT, true, false>(op, a, stream);
  return a.alive ? launch_scan<Op, kT, false, true>(op, a, stream)
                 : launch_scan<Op, kT, false, false>(op, a, stream);
}

template <class Op>
cudaError_t launch_scan_flags(const Op& op, const ScanArgs& a, bool keep2,
                              cudaStream_t stream) {
  return a.n_q == 1 ? launch_scan_tile<Op, 1>(op, a, keep2, stream)
                    : launch_scan_tile<Op, kQT>(op, a, keep2, stream);
}

// Stage a tile of kT queries, `stride` items per query (items past `per_q`
// and queries past nq are zero): tile[qq * stride + i] = src[(q0 + qq) *
// per_q + i].
template <int kT, typename V>
__device__ __forceinline__ void stage_tile(V* tile, const V* src, int per_q, int stride,
                                           int q0, int nq, V zero) {
  for (int t = threadIdx.x; t < kT * stride; t += blockDim.x) {
    const int qq = t / stride;
    const int i = t - qq * stride;
    tile[t] = qq < nq && i < per_q ? src[(long long)(q0 + qq) * per_q + i] : zero;
  }
}

// A lane's words of a row held in a ring stage: words lane, lane + 32, ...
template <int kWords>
__device__ __forceinline__ void read_words(const char* stage, int wpr, int lane,
                                           uint32_t (&w)[kWords]) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(stage);
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int k = lane + 32 * j;
    w[j] = k < wpr ? src[k] : 0u;
  }
}

// Sign-extended byte k (0..3) of a 32-bit word, as a float (exact).
__device__ __forceinline__ float byte_f32(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

// x rounded to bf16 (to nearest even) and back: the TPU's bf16 MXU input.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace memex
