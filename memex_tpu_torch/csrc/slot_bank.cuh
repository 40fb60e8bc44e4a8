// Pieces shared by the scan kernels (fused_topk*.cu, ivf_*.cu): the warp's
// transpose-reduce and the per-slot fold of memex_tpu/ops/fused_topk.py's
// _fold_chunks, the slot walk with its cp.async row ring, and the
// float-query row scoring.
//
// Every scan kernel gives one warp one slot s of the S-slot bank and one
// tile of queries (32, or a single query alone). The warp walks the slot's
// columns in the TPU's fold order -- s, s+S, s+2S, ... for the flat scans,
// row s of each chunk of the probed clusters for the IVF scans -- so its
// fold keeps the TPU's tie rule (strict '>': the earlier column wins)
// without any merge across blocks. Lane l scores its slice of the row
// against every query of the tile; the transpose-reduce then leaves lane l
// holding the whole score of query l, which lane l folds into the
// (query l, slot) pair it owns.

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

// Outputs of one scan launch.
struct ScanArgs {
  const float* scales;  // [n_rows] row scales, or null (scale 1)
  float scale_mul;      // score = raw * (scales[col] * scale_mul)
  const float* alive;   // [n_rows] or null
  float* v;
  int* i;
  float* v2;
  int* i2;
  int n_q, n_slots;
};

// The flat scan's walk: slot s folds columns s, s + S, s + 2S, ... below
// `limit` (min(count, n_rows)); column c is row c of the table.
// A walk gives, for the warp owning `slot` in the query tile at q0, its
// number of steps and, for step u, the column it folds (its row in the
// table and its fold index), or -1 for a masked step, which reads nothing.
struct FlatWalk {
  long long limit;
  int n_slots;

  __device__ __forceinline__ long long steps(int slot, int) const {
    return slot < limit ? (limit - slot + n_slots - 1) / n_slots : 0;
  }
  __device__ __forceinline__ long long col(int slot, int, long long u) const {
    return slot + u * n_slots;
  }
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

// Bytes of one stage of a warp's ring: the row, then a 16-byte tail with
// what the kernel folds it with (scan_kernel: its scale and alive entries
// and its column; K6: the scales of its row pair, the column and how many
// of the pair are live).
__host__ __device__ constexpr int stage_bytes(int row_bytes) { return row_bytes + 16; }
static_assert((kScanStages & (kScanStages - 1)) == 0, "the ring index is a mask");

// The warp's copies of one row into a stage.
__device__ __forceinline__ void copy_row(char* dst, const char* src, int row_bytes, int lane) {
  for (int c = lane; c < row_bytes / 16; c += 32) cp_async16(dst + 16 * c, src + 16 * c);
}

// The ring protocol of every scan kernel, for the n steps of one warp's
// walk. request(s, u) issues step u's copies (none past the walk's end)
// and its tail into stage s and commits one group, so the wait below
// counts stages; read(stage, step) takes a landed stage out into a Step
// (the row and its tail, in registers) and says whether it is live
// (warp-uniform); score(step) scores and folds it. Steps 0 ..
// kScanStages - 1 are requested before stage_queries() fills the block's
// query tile, so the first rows are in flight meanwhile; step u +
// kScanStages is requested as soon as step u is read out, so kScanStages
// rows are always in flight per warp.
template <class Step, class Request, class StageQueries, class Read, class Score>
__device__ __forceinline__ void ring_walk(const char* ring, int sbytes, long long n,
                                          Request&& request, StageQueries&& stage_queries,
                                          Read&& read, Score&& score) {
  for (int s = 0; s < kScanStages; ++s) request(s, s);
  stage_queries();
  __syncthreads();
  for (long long u = 0; u < n; ++u) {
    const int s = static_cast<int>(u) & (kScanStages - 1);
    cp_async_wait<kScanStages - 1>();  // this lane's copies of the oldest stage landed
    __syncwarp();                      // ... and every other lane's, and lane 0's tail
    Step step;
    const bool live = read(ring + s * sbytes, step);
    __syncwarp();  // the stage is read out: refill it
    request(s, u + kScanStages);
    if (live) score(step);
  }
  cp_async_wait<0>();
}

// The slot walk of the scan kernels, for a tile of kT queries (1 or 32).
// `Op` supplies the row type and the lane's partial dots:
//   Op::Row, Op::Acc, op.row_bytes() (a multiple of 16), op.db (the rows),
//   op.tile_bytes(kT) (a multiple of 16), op.stage<kT>(tile, q0, nq),
//   op.read(stage, lane, Row&), op.partial<kT>(const Row&, tile, lane, Acc (&)[kT]).
// `Walk` supplies the warp's columns in fold order (FlatWalk above; the IVF
// kernels walk cluster chunks). The tile's rows past nq are zero, so the
// partial dots run unguarded over all kT queries (straight-line code the
// compiler can interleave); a single query gets its own one-query tile
// rather than 31 wasted ones. Each warp streams its slot's rows, with their
// scale and alive entries, through its ring (ring_walk above).
template <class Op, class Walk, int kT, bool kKeep2, bool kAlive>
__global__ void __launch_bounds__(kScanWarps * 32)
scan_kernel(const Op op, const Walk walk, const ScanArgs a) {
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
  const long long n = walk.steps(slot, q0);

  // Step u into stage s: the row's copies, and its column (-1: masked or
  // past the end, nothing copied) in the tail.
  auto request = [&](int s, long long u) {
    char* dst = ring + s * sbytes;
    const long long col = u < n ? walk.col(slot, q0, u) : -1;
    if (col >= 0) {
      copy_row(dst, rows + col * row_bytes, row_bytes, lane);
      if (a.scales && lane == 31) cp_async4(dst + row_bytes, a.scales + col);
      if (kAlive && lane == 30) cp_async4(dst + row_bytes + 4, a.alive + col);
    }
    if (lane == 0) *reinterpret_cast<long long*>(dst + row_bytes + 8) = col;
    cp_async_commit();
  };

  struct Step {
    typename Op::Row row;
    long long col;
    float scale;
  };
  SlotBank<kKeep2> bank;
  ring_walk<Step>(
      ring, sbytes, n, request, [&] { op.template stage<kT>(tile, q0, nq); },
      [&](const char* st, Step& t) {
        t.col = *reinterpret_cast<const long long*>(st + row_bytes + 8);
        t.scale = a.scales ? *reinterpret_cast<const float*>(st + row_bytes) : 1.f;
        // A masked or dead row is skipped whole, as a -1e30 score is a
        // no-op in the fold.
        const bool live =
            t.col >= 0 && (!kAlive || *reinterpret_cast<const float*>(st + row_bytes + 4) > 0.f);
        if (live) op.read(st, lane, t.row);
        return live;
      },
      [&](const Step& t) {
        typename Op::Acc part[kT];
        op.template partial<kT>(t.row, tile, lane, part);
        reduce_tile<kT>(part, lane);
        // One rounding of the exact dot (integer kernels), then the scale:
        // the TPU kernels' `raw.astype(f32) * scale`.
        bank.fold(static_cast<float>(part[0]) * (t.scale * a.scale_mul), static_cast<int>(t.col));
      });
  if (lane < nq) bank.store(a.v, a.i, a.v2, a.i2, (long long)(q0 + lane) * a.n_slots + slot);
}

template <class Op, class Walk, int kT, bool kKeep2, bool kAlive>
cudaError_t launch_scan(const Op& op, const Walk& walk, const ScanArgs& a, cudaStream_t stream) {
  auto kernel = scan_kernel<Op, Walk, kT, kKeep2, kAlive>;
  const size_t smem =
      op.tile_bytes(kT) + (size_t)kScanWarps * kScanStages * stage_bytes(op.row_bytes());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_slots / kScanWarps, (a.n_q + kT - 1) / kT);
  kernel<<<grid, kScanWarps * 32, smem, stream>>>(op, walk, a);
  return cudaGetLastError();
}

template <class Op, class Walk, int kT>
cudaError_t launch_scan_tile(const Op& op, const Walk& walk, const ScanArgs& a, bool keep2,
                             cudaStream_t stream) {
  if (keep2)
    return a.alive ? launch_scan<Op, Walk, kT, true, true>(op, walk, a, stream)
                   : launch_scan<Op, Walk, kT, true, false>(op, walk, a, stream);
  return a.alive ? launch_scan<Op, Walk, kT, false, true>(op, walk, a, stream)
                 : launch_scan<Op, Walk, kT, false, false>(op, walk, a, stream);
}

template <class Op, class Walk>
cudaError_t launch_scan_flags(const Op& op, const Walk& walk, const ScanArgs& a, bool keep2,
                              cudaStream_t stream) {
  return a.n_q == 1 ? launch_scan_tile<Op, Walk, 1>(op, walk, a, keep2, stream)
                    : launch_scan_tile<Op, Walk, kQT>(op, walk, a, keep2, stream);
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

// Four row elements loaded as one unit, and their float32 values. kBf16Exact:
// the values are already bf16 numbers (int8 codes are integers below 2^8).
struct Int8x4 {
  using Raw = uint32_t;
  static constexpr bool kBf16Exact = true;
  __device__ __forceinline__ static float4 widen(Raw w) {
    return make_float4(byte_f32(w, 0), byte_f32(w, 1), byte_f32(w, 2), byte_f32(w, 3));
  }
};
struct Bf16x4 {
  using Raw = uint2;
  static constexpr bool kBf16Exact = true;
  __device__ __forceinline__ static float4 widen(Raw w) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
struct F32x4 {
  using Raw = float4;
  static constexpr bool kBf16Exact = false;
  __device__ __forceinline__ static float4 widen(Raw w) { return w; }
};

// Rows of d elements (d / 4 units of `Unit`) against float32 queries held
// as a float4 tile in shared memory, FP32 FMA. kRound rounds both inputs to
// bf16 (the queries when staged, float32 rows when scored): the TPU
// kernels' bf16 MXU inputs with f32 accumulation. Without it (float32 rows,
// `exact`) every operation is float32. A lane holds units lane, lane + 32,
// lane + 64 of a row, so d <= kMaxDim.
template <class Unit, bool kRound>
struct FloatTileOp {
  static constexpr int kUnits = 3;                 // units per lane
  static constexpr int kTileUnits = 32 * kUnits;   // units per query in a tile (zero past d / 4)
  static constexpr int kMaxDim = 4 * kTileUnits;   // 384
  struct Row {
    typename Unit::Raw u[kUnits];
  };
  using Acc = float;
  const float4* q;  // [n_q, upr] float32 queries, 4 per unit of a row
  const void* db;   // [n_rows, d] rows
  int upr;          // units per row: d / 4

  __host__ __device__ int row_bytes() const { return static_cast<int>(sizeof(typename Unit::Raw)) * upr; }
  __host__ __device__ int tile_bytes(int kT) const { return 16 * kT * kTileUnits; }

  template <int kT>
  __device__ void stage(char* tile, int q0, int nq) const {
    float4* qs = reinterpret_cast<float4*>(tile);
    for (int t = threadIdx.x; t < kT * kTileUnits; t += blockDim.x) {
      const int qq = t / kTileUnits;
      const int i = t - qq * kTileUnits;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qq < nq && i < upr) {
        v = q[(long long)(q0 + qq) * upr + i];
        if (kRound) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
          v.w = round_bf16(v.w);
        }
      }
      qs[t] = v;
    }
  }

  __device__ __forceinline__ void read(const char* st, int lane, Row& r) const {
    const typename Unit::Raw* src = reinterpret_cast<const typename Unit::Raw*>(st);
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int k = lane + 32 * j;
      r.u[j] = k < upr ? src[k] : typename Unit::Raw{};
    }
  }

  template <int kT>
  __device__ __forceinline__ void partial(const Row& r, const char* tile, int lane,
                                          float (&part)[kT]) const {
    const float4* qs = reinterpret_cast<const float4*>(tile) + lane;
    float4 x[kUnits];
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      x[j] = Unit::widen(r.u[j]);
      if (kRound && !Unit::kBf16Exact) {
        x[j].x = round_bf16(x[j].x);
        x[j].y = round_bf16(x[j].y);
        x[j].z = round_bf16(x[j].z);
        x[j].w = round_bf16(x[j].w);
      }
    }
#pragma unroll
    for (int qq = 0; qq < kT; ++qq) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        const float4 qv = qs[qq * kTileUnits + 32 * j];
        acc = fmaf(x[j].x, qv.x, acc);
        acc = fmaf(x[j].y, qv.y, acc);
        acc = fmaf(x[j].z, qv.z, acc);
        acc = fmaf(x[j].w, qv.w, acc);
      }
      part[qq] = acc;
    }
  }
};

}  // namespace memex
