// Pieces shared by the scan kernels (fused_topk*.cu, ivf_*.cu): the warp's
// transpose-reduce and the per-slot fold of memex_tpu/ops/fused_topk.py's
// _fold_chunks, the slot walk with its cp.async row ring, the float-query
// row scoring on the FP32 pipe, and the tensor-core scoring body.
//
// Every scan kernel gives one warp one slot s of the S-slot bank and one
// tile of queries. The warp walks the slot's columns in the TPU's fold
// order -- s, s+S, s+2S, ... for the flat scans, row s of each chunk of the
// probed clusters for the IVF scans -- so its fold keeps the TPU's tie rule
// (strict '>': the earlier column wins) without any merge across blocks.
// (K7 alone splits a query's walk into contiguous pieces, each folded by
// one warp, and merges them in walk order: exact for its single-winner
// fold, ivf_scan.cu.) Two bodies score the rows:
//   - scan_kernel (SIMT, FP32 FMA; tiles of 32 queries, or one alone; only
//     the exact modes of K1 and K5, float32 throughout):
//     lane l scores its slice of the row against every query of the tile;
//     the transpose-reduce then leaves lane l holding the whole score of
//     query l, which lane l folds into the (query l, slot) pair it owns;
//   - mma_scan_kernel (tensor cores: bf16 or f16 in with f32 accumulate,
//     or s8 in with s32 accumulate; tiles of up to 128 queries): a producer
//     warp brings the block's rows with bulk copies; each consumer warp
//     scores 16 steps of its walk at a time with mma.sync, parks the 16 x
//     32-query scores in shared memory, and lane l folds query l's 16
//     scores in step order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One step of a block of the tensor-core body: the block's slots read
// `live` contiguous rows of the table from row0 on (a prefix of the slots;
// the others are masked), and the first one folds as column col0. A row-pair
// walk (K6: a packed row scores two logical rows) also says how many of
// them, again a prefix, have a live second row.
struct BlockStep {
  long long row0;
  int col0, live, live2;
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
  // Step u of the w slots from s0 on (the tensor-core body's block): their
  // rows are contiguous in the table, and the live ones are a prefix.
  __device__ __forceinline__ BlockStep block_step(int s0, int, long long u, int w) const {
    const long long col0 = s0 + u * n_slots;
    const long long left = limit - col0;
    return {col0, static_cast<int>(col0),
            left <= 0 ? 0 : (left < w ? static_cast<int>(left) : w), 0};
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
// what the kernel folds it with (its scale and alive entries and its
// column).
__host__ __device__ constexpr int stage_bytes(int row_bytes) { return row_bytes + 16; }
static_assert((kScanStages & (kScanStages - 1)) == 0, "the ring index is a mask");

// The warp's copies of one row into a stage.
__device__ __forceinline__ void copy_row(char* dst, const char* src, int row_bytes, int lane) {
  for (int c = lane; c < row_bytes / 16; c += 32) cp_async16(dst + 16 * c, src + 16 * c);
}

// The ring protocol of the SIMT body, for the n steps of one warp's
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

// x rounded to bf16 (to nearest even) and back: the TPU's bf16 MXU input.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// float32 rows of d elements (d / 4 float4 units) against float32 queries
// held as a float4 tile in shared memory, FP32 FMA: every operation is
// float32 (the exact modes of K1 and K5, which must never meet TF32). A
// lane holds units lane, lane + 32, lane + 64 of a row, so d <= kMaxDim.
struct FloatTileOp {
  static constexpr int kUnits = 3;                 // units per lane
  static constexpr int kTileUnits = 32 * kUnits;   // units per query in a tile (zero past d / 4)
  static constexpr int kMaxDim = 4 * kTileUnits;   // 384
  struct Row {
    float4 u[kUnits];
  };
  using Acc = float;
  const float4* q;  // [n_q, upr] float32 queries, 4 per unit of a row
  const void* db;   // [n_rows, d] float32 rows
  int upr;          // units per row: d / 4

  __host__ __device__ int row_bytes() const { return static_cast<int>(sizeof(float4)) * upr; }
  __host__ __device__ int tile_bytes(int kT) const { return 16 * kT * kTileUnits; }

  template <int kT>
  __device__ void stage(char* tile, int q0, int nq) const {
    float4* qs = reinterpret_cast<float4*>(tile);
    for (int t = threadIdx.x; t < kT * kTileUnits; t += blockDim.x) {
      const int qq = t / kTileUnits;
      const int i = t - qq * kTileUnits;
      qs[t] = qq < nq && i < upr ? q[(long long)(q0 + qq) * upr + i]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void read(const char* st, int lane, Row& r) const {
    const float4* src = reinterpret_cast<const float4*>(st);
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int k = lane + 32 * j;
      r.u[j] = k < upr ? src[k] : float4{};
    }
  }

  template <int kT>
  __device__ __forceinline__ void partial(const Row& r, const char* tile, int lane,
                                          float (&part)[kT]) const {
    const float4* qs = reinterpret_cast<const float4*>(tile) + lane;
    const float4 (&x)[kUnits] = r.u;
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


// -- The tensor-core body -------------------------------------------------------
//
// At every batch size: K1 on float32 and bf16 rows, K5 on int8, bf16 and
// float32 rows and K7 on those three (gathered query tiles, below), all in
// the non-exact modes (bf16 inputs, f32 accumulate: MmaTileOp below); K3
// with K5's int8 product on the flat walk, K2 on int8 rows against int8
// queries (s8 x s8 -> s32, fused_topk_int8.cu), K4 on packed int4 rows in
// both its modes (fused_topk_int4.cu) and K6 on row-pair packed int4 rows,
// two folds a step (ivf_batch4.cu). The SIMT body above reads its query tile from
// shared memory once per row (12-48 KB a row for 32 queries at D = 384) and
// issues every product on the FP32 or integer pipe; this one
//   - stages the block's query tile once, up to 128 queries, in the
//     product's input type, so a row leaves device memory once per batch of
//     128 (a gathered walk's tile is any set of the batch's queries, and
//     their banks go where the walk says: GatheredWalk below);
//   - gives the block's kW slots one producer warp: a block step, the rows
//     of the kW slots at one step of the walk, is kW contiguous rows of the
//     table (flat: columns u * S + s0 ...; K5, K6: rows of one chunk), so one
//     bulk copy (the Tensor Memory Accelerator) brings its live prefix into
//     a ring stage, and an mbarrier says when it landed. The producer keeps
//     up to kRing steps in flight while the consumer warps score, so the
//     loads overlap the products instead of alternating with them;
//   - has a consumer warp, which owns one slot and one group of kNT * 8
//     queries of the tile, score a group of 16 * kMT steps at a time with
//     mma.sync: A is its slot's row in those stages, B the query tile, read
//     with ldmatrix once per group. `Op` supplies the products (its operand
//     types, the A conversion, the k-loop). Two m-tiles a group (K2, K4, K6)
//     give a lone warp on its scheduler two independent chains of products
//     and halve the tile reads and barrier waits a row; they need a ring of
//     more than 32 stages and 2 * kNT * 4 accumulators. With kG > 1 query groups
//     a slot's rows are scored by kG warps, each on its own queries: more
//     warps in flight where the bank has few slots (K2: S = 512), and the
//     fold is untouched, since queries never meet in it;
//   - keeps the fold exact: an m-tile's 16 x kNT * 8 accumulators go, 32
//     queries at a time, to a per-warp 16 x 32 score tile in shared memory, each score
//     one rounding of the dot times its row's scale, or -1e30 for a masked
//     or dead step (a no-op in the fold), and lane l folds query l's 16
//     scores in step order through the same SlotBank; an Op with two folds
//     a step (K6) passes each of its two score sets through the tile in turn
//     into banks of their own, so each slot still sees its candidates in
//     step order. A group with no live
//     step is neither scored nor folded. A step's first column, its live
//     rows and their scale and alive entries come with the stage: the
//     producer reads them a batch ahead and writes them behind the rows, so
//     no consumer waits on device memory for them (read by the consumers
//     themselves, even two groups ahead, those loads cost K2 a fifth of
//     its time at 32 queries).
// Measured on the H100 (PERF.md, section 6): the per-warp cp.async rings this
// replaced spent most of each warp's time issuing copies, so a warp's loads
// and its products ran one after the other (their sum was the kernel's
// time); stage strides at an odd multiple of 16 bytes past a multiple of 128
// keep the A reads of a group's 8 + 8 steps in distinct banks.

constexpr int kMmaSteps = 16;                    // steps per mma: its m
constexpr int kMmaTileQ = 128;                   // queries per block tile at most
constexpr int kFoldQ = 32;                       // queries per fold pass, one per lane
constexpr int kScoreStride = kFoldQ + 8;         // floats per step of the score tile:
                                                 // float2 stores and column reads
                                                 // without bank conflicts
constexpr int kMmaMaxDim = 384;                  // the widest row the body takes
constexpr int kMaxBlockSmem = 232448;            // shared memory a block may have
constexpr int kMaxMT = 2;                        // m-tiles (16 steps) a group at most
constexpr int kGroupSteps = kMaxMT * kMmaSteps;  // steps a group at most: one a lane
// A consumer warp's shared memory: its score tile, and a group's step tails
// for each fold of a step.
__host__ __device__ constexpr int warp_smem(int folds) {
  return kMmaSteps * kScoreStride * 4 + folds * kGroupSteps * 8;
}
constexpr int kMaxRing = 48;                     // stages a ring holds at most, per m-tile of a group

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

// Row types of the bf16 product: a pair of neighbouring elements as one
// bf16x2 A register, the slots of a block (float32 rows fit only 4 beside a
// 128-query tile; with 8, bf16 rows fit 17 stages there, and 8 warps with 17
// stages measured 10% faster than 4 with 39), and kTail, the bytes of a ring
// stage past its rows: the step's tail (stage_tail_bytes below) and padding.
struct Int8Rows {
  static constexpr int kElemBytes = 1, kWarps = 8, kTail = 80;
  // Without the conversion pipe: code v becomes the float 2^23 + (v + 128)
  // by placing the byte v ^ 0x80 under the exponent of 2^23, less 2^23 +
  // 128 gives v exactly, and a small integer's float has bf16 in its top
  // half.
  __device__ __forceinline__ static uint32_t pair(const char* p) {
    const unsigned w = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
    const float lo = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440)) - 8388736.f;
    const float hi = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7441)) - 8388736.f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
};
struct Bf16Rows {
  static constexpr int kElemBytes = 2, kWarps = 8, kTail = 80;
  __device__ __forceinline__ static uint32_t pair(const char* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
};
struct F32Rows {
  static constexpr int kElemBytes = 4, kWarps = 4, kTail = 96;
  __device__ __forceinline__ static uint32_t pair(const char* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return bf16x2(v.x, v.y);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b for one 16 x 8 tile, k = 16: bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b for one 16 x 8 tile, k = 32: s8 in (four codes along k a
// register), s32 accumulate: exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's ldmatrix row for a pair of n-tiles of a [query][k] tile whose
// queries are `stride` bytes apart, at k byte 0 of query `qbase` on: lanes
// 0-7 address n-tile j's 8 queries at 16 bytes of k, 8-15 the same queries
// at the next 16 bytes, 16-31 n-tile j + 1. The four registers are then the
// B fragments of the two n-tiles for one k-step of 32 bytes (16 bf16 or
// f16 values, or 32 int8 codes: a b16 matrix's row of 8 is 16 codes, and a
// lane's register holds four along k, as mma_s8 wants them).
__device__ __forceinline__ unsigned b_lane_addr(unsigned tile, int stride, int qbase, int lane) {
  return tile + (qbase + (lane & 7) + 8 * (lane >> 4)) * stride + 16 * ((lane >> 3) & 1);
}

// Int8 queries in a tile: a query's d codes, zero up to the next multiple
// of `to` (a power of two: the codes a pass of the k-loop takes, so a d that
// is only a multiple of 16 ends on zero products). A tile row of one or two
// such parts plus 16 bytes is an odd multiple of 16 bytes: ldmatrix's 8
// rows land in distinct banks.
__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) & ~(to - 1); }

// Stage int8 queries [n_q, d] (d % 16 == 0, rows 16-byte aligned) as the
// part at `tile` of a tile whose tq queries are `stride` bytes apart, zero
// from d to `padded` and past nq.
__device__ __forceinline__ void stage_s8_tile(char* tile, int stride, const char* src, int d,
                                              int padded, int q0, int nq, int tq) {
  const int units = padded / 16;
  for (int t = threadIdx.x; t < tq * units; t += blockDim.x) {
    const int qq = t / units;
    const int i = t - qq * units;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qq < nq && 16 * i < d)
      v = *reinterpret_cast<const uint4*>(src + (long long)(q0 + qq) * d + 16 * i);
    *reinterpret_cast<uint4*>(tile + qq * stride + 16 * i) = v;
  }
}

// What the body asks of an Op (MmaTileOp below; Int8qMmaOp, ShiftMmaOp and
// DeferredMmaOp in fused_topk_int8.cu and fused_topk_int4.cu):
//   Op::Acc                     float or int accumulators
//   Op::kFolds                  folds a step: 1, or 2 where a row scores two
//                               logical rows (K6): fold f of the warp's slot
//                               s lands in slot s + f * S / kFolds with
//                               column col + f * S / kFolds, the block grid
//                               covers S / kFolds slots, and the second
//                               fold's scale rides where the alive entries
//                               do (such a scan has none)
//   Op::kTail                   bytes of a ring stage past its rows: at
//                               least stage_tail_bytes(kW), a multiple of 16
//   Op::kMaxRowBytes, Op::max_tile_bytes(tq)   at the widest row, to size the ring
//   op.db, op.row_bytes()       the rows (a multiple of 16 bytes each)
//   op.tile_bytes(tq)           of the staged tile of tq queries
//   op.stage_tile(tile, q0, nq, tq)            all threads of the block
//   op.stage_rows(tile, row_of, tq)            the same for a gathered walk
//                                              (MmaTileOp only): tile query
//                                              qq is batch row row_of(qq),
//                                              or zeros where that is -1
//   op.products<kNT, kMT>(acc, ar, tile, qbase, lane)
//       kMT m-tiles a group: a warp scores 16 * kMT steps at a time, and a B
//       fragment read serves them all;
//       acc[kFolds * t + f] += fold f's raw scores of the warp's rows at
//       steps 16t + lane / 4 (ar[2t]) and 16t + lane / 4 + 8 (ar[2t + 1])
//       against queries qbase .. qbase + kNT * 8 of the tile, in mma.sync's
//       fragment layout (acc[.][j][0..1]: step 16t + lane / 4, queries 8j +
//       2 * (lane % 4) and the next; acc[.][j][2..3]: step 16t + lane / 4 +
//       8).

// float32 queries and rows of d elements (d % 16 == 0) for the bf16 product.
template <class Rows>
struct MmaTileOp {
  using Acc = float;
  static constexpr int kFolds = 1;
  static constexpr int kTail = Rows::kTail;
  static constexpr int kMaxRowBytes = Rows::kElemBytes * kMmaMaxDim;
  __host__ __device__ static constexpr int max_tile_bytes(int tq) {
    return tq * (2 * kMmaMaxDim + 16);
  }
  const float* q;  // [n_q, d]
  const void* db;  // rows of d elements
  int d;

  __host__ __device__ int row_bytes() const { return Rows::kElemBytes * d; }
  // A bf16 query row plus 16 bytes: ldmatrix's 8 rows land in distinct banks.
  __host__ __device__ int tile_stride() const { return 2 * d + 16; }
  __host__ __device__ int tile_bytes(int tq) const { return tq * tile_stride(); }

  // The query tile as bf16: tile query qq < tq is batch row row_of(qq), or
  // zeros where that is -1. A thread issues kBatch float4 loads before it
  // converts and stores them, so a block waits for ~tq * d / (4 * threads *
  // kBatch) loads in turn, not one per element: a tile of 128 queries is
  // 12,288 float4s, 43 a thread (K7 stages one per work item).
  template <class RowOf>
  __device__ __forceinline__ void stage_rows(char* tile, RowOf&& row_of, int tq) const {
    constexpr int kBatch = 8;
    const int qd = d / 4;  // float4 units a query
    const int tstride = tile_stride();
    const int n = tq * qd;
    const float4* const q4 = reinterpret_cast<const float4*>(q);
    for (int t0 = threadIdx.x; t0 < n; t0 += kBatch * blockDim.x) {
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int t = t0 + k * blockDim.x;
        const int qq = t / qd;
        const long long row = t < n ? row_of(qq) : -1;
        v[k] = row >= 0 ? q4[row * qd + (t - qq * qd)] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int t = t0 + k * blockDim.x;
        const int qq = t / qd;
        if (t < n)
          *reinterpret_cast<uint2*>(tile + qq * tstride + 8 * (t - qq * qd)) =
              make_uint2(bf16x2(v[k].x, v[k].y), bf16x2(v[k].z, v[k].w));
      }
    }
  }
  __device__ __forceinline__ void stage_tile(char* tile, int q0, int nq, int tq) const {
    stage_rows(tile, [q0, nq](int qq) -> long long { return qq < nq ? q0 + qq : -1; }, tq);
  }

  // A is converted to bf16 pairs (int8 codes and bf16 values exactly,
  // float32 rounded to nearest even, as round_bf16); each k-step loads all
  // its operands before its products.
  template <int kNT, int kMT>
  __device__ __forceinline__ void products(float (&acc)[kMT][kNT][4],
                                           const char* const (&rows)[2 * kMT], unsigned tile,
                                           int qbase, int lane) const {
    static_assert(kMT == 1, "a 128-query bf16 tile leaves the ring no room for 32-step groups");
    constexpr int kEB = Rows::kElemBytes;
    const int tstride = tile_stride();
    const unsigned b_lane = b_lane_addr(tile, tstride, qbase, lane);
    const char* const ar = rows[0] + 2 * (lane & 3) * kEB;  // columns 2c, 2c + 1 of the fragment
    const char* const ar8 = rows[1] + 2 * (lane & 3) * kEB;
#pragma unroll 2
    for (int k0 = 0; k0 < d; k0 += 16) {
      const int e = k0 * kEB;
      const uint32_t af[4] = {Rows::pair(ar + e), Rows::pair(ar8 + e),
                              Rows::pair(ar + e + 8 * kEB), Rows::pair(ar8 + e + 8 * kEB)};
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) ldmatrix_x4(bf[j], b_lane + j * 16 * tstride + 2 * k0);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        mma_bf16(acc[0][2 * j], af, bf[j][0], bf[j][1]);
        mma_bf16(acc[0][2 * j + 1], af, bf[j][2], bf[j][3]);
      }
    }
  }
};

// Ring stages that fit beside a tile of tq queries and the score tiles of
// kW * kG consumer warps, at the widest row (each stage: a row per slot,
// the padding, two mbarriers).
template <class Op, int kW, int kG, int kMT>
__host__ __device__ constexpr int mma_ring(int tq) {
  const int fixed = Op::max_tile_bytes(tq) + kW * kG * warp_smem(Op::kFolds);
  const int stage = kW * Op::kMaxRowBytes + Op::kTail + 16;
  const int ring = (kMaxBlockSmem - fixed) / stage;
  return ring > kMT * kMaxRing ? kMT * kMaxRing : ring;
}

// A gathered walk (K7's probe tiles, ivf_scan.cu): block row y of the grid
// is item y of a work list, whose query tile is any set of the batch's
// queries and whose banks are stored at rows the walk names. Every other
// walk is the identity: block row y takes queries y * kMmaTileQ on and
// stores their banks at their own rows. A gathered walk gives
//   Walk::Item, walk.item(y)             what block row y walks, read once
//   walk.n_items                         block rows of the grid
//   walk.queries(it)                     its queries (0: past the list; the
//                                        block exits)
//   walk.query(it, qq)                   the batch row of tile query qq
//   walk.out_row(it, qq)                 the bank row its bank is stored at
//   walk.steps(s0, it), walk.block_step(s0, it, u, w)  as any walk
template <class W, class = void>
struct GatheredWalk : std::false_type {};
template <class W>
struct GatheredWalk<W, std::void_t<typename W::Item>> : std::true_type {};

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier at bar.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// What the fold takes of a step besides its score: its column (-1: masked
// or dead) and the multiplier of its raw dot, (scale or 1) * scale_mul.
struct StepTail {
  int col;
  float mul;
};

// A block step's tail in its ring stage, behind the kW rows: the scale and
// the alive entry of each row (1 where the scan has none; with two folds a
// step, the scale of the row's second fold), then the first row's column
// and, a byte each, how many of the kW, a prefix, are live and how many
// have a live second fold.
__host__ __device__ constexpr int stage_tail_bytes(int kW) { return 8 * kW + 8; }

// kW slots a block (kW rows a step), kG query groups of kNT n-tiles (8
// queries) each: kW * kG consumer warps and the producer; kMT m-tiles (16
// steps) a group; Op::kFolds folds a step.
template <class Op, int kW, int kNT, int kG, int kMT, class Walk, bool kKeep2, bool kAlive>
__global__ void __launch_bounds__((kW * kG + 1) * 32)
mma_scan_kernel(const Op op, const Walk walk, const ScanArgs a) {
  static_assert(kNT % 2 == 0 && kNT * 8 * kG <= kMmaTileQ, "n-tiles come in pairs");
  static_assert(kW * kG + 1 <= 32, "a block has at most 1,024 threads");
  static_assert(kW % 4 == 0 && Op::kTail % 16 == 0 && Op::kTail >= stage_tail_bytes(kW),
                "a stage holds its step's tail behind the rows, 16-byte aligned");
  using Acc = typename Op::Acc;
  constexpr int kF = Op::kFolds;
  static_assert(kF == 1 || (kF == 2 && !kAlive), "a second fold's scale takes the alive entry's place");
  constexpr int kSteps = kMT * kMmaSteps;  // steps a group: one a lane at most
  static_assert(kMT >= 1 && kMT <= kMaxMT, "a lane waits for one step of a group");
  constexpr int kTileQ = kNT * 8 * kG;
  constexpr int kRing = mma_ring<Op, kW, kG, kMT>(kTileQ);
  static_assert(kRing > kSteps, "the ring holds a group and more");
  constexpr int kPasses = (kNT * 8 + kFoldQ - 1) / kFoldQ;
  constexpr int kWarpSmem = warp_smem(kF);
  constexpr bool kGathered = GatheredWalk<Walk>::value;
  extern __shared__ uint4 smem_raw[];
  char* const tile = reinterpret_cast<char*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gap = a.n_slots / kF;  // from a slot and its column to its next fold's
  // The block's queries: q0 = blockIdx.y * kMmaTileQ on, or a gathered
  // walk's item.
  const auto it = [&] {
    if constexpr (kGathered)
      return walk.item(blockIdx.y);
    else
      return static_cast<int>(blockIdx.y) * kMmaTileQ;
  }();
  int nq;
  if constexpr (kGathered) {
    nq = walk.queries(it);
    if (nq <= 0) return;  // past the work list: the whole block leaves
  } else {
    nq = min(kTileQ, a.n_q - it);
  }
  const int row_bytes = op.row_bytes();
  const int sbytes = kW * row_bytes + Op::kTail;
  char* const ring = tile + op.tile_bytes(kTileQ);
  char* const warps_smem = ring + kRing * sbytes;
  const unsigned full = smem_addr(warps_smem + kW * kG * kWarpSmem);  // [kRing]: a stage landed
  const unsigned empty = full + 8 * kRing;                            // [kRing]: a stage was read
  const char* const rows = static_cast<const char*>(op.db);
  const int s0 = blockIdx.x * kW;
  // The block's steps: its first slot's (columns are int32, so steps are).
  const int nb = static_cast<int>(walk.steps(s0, it));

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kW * kG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kGathered) {
    // The tile's batch rows, looked up once into the score tiles' memory
    // (unused until the walk starts), then the tile.
    int* const rows_of = reinterpret_cast<int*>(warps_smem);
    for (int qq = threadIdx.x; qq < kTileQ; qq += blockDim.x)
      rows_of[qq] = qq < nq ? walk.query(it, qq) : -1;
    __syncthreads();
    op.stage_rows(tile, [rows_of](int qq) -> long long { return rows_of[qq]; }, kTileQ);
  } else {
    op.stage_tile(tile, it, nq, kTileQ);
  }
  __syncthreads();

  if (warp == kW * kG) {
    // The producer. Lane l issues step ub + l of a batch of kSteps (what the
    // consumers release together) into a stage they have released: one
    // lane issuing every step in turn took ~250 clocks a step, more than
    // the consumers need for a 1.5 KB step of a narrow bank. It reads the
    // step's tail from device memory a batch ahead, writes it behind the
    // stage's rows, and its arrive publishes it with the rows.
    struct Fetched {
      BlockStep at;
      float scale[kW], second[kW];  // second: the alive entry, or the second fold's scale
    };
    auto fetch = [&](int u) {
      Fetched f;
      f.at = lane < kSteps && u < nb ? walk.block_step(s0, it, u, kW) : BlockStep{0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        f.scale[i] = a.scales && i < f.at.live ? a.scales[(long long)f.at.col0 + i] : 1.f;
        if constexpr (kF == 2)
          f.second[i] = a.scales && i < f.at.live2 ? a.scales[(long long)f.at.col0 + gap + i] : 1.f;
        else
          f.second[i] = kAlive && i < f.at.live ? a.alive[(long long)f.at.col0 + i] : 1.f;
      }
      return f;
    };
    Fetched cur = fetch(lane);
    for (int ub = 0; ub < nb; ub += kSteps) {
      const int u = ub + lane;
      const Fetched ahead = fetch(u + kSteps);
      if (lane < kSteps && u < nb) {
        const int s = u % kRing;
        if (u >= kRing) mbar_wait(empty + 8 * s, static_cast<unsigned>(u / kRing - 1) & 1u);
        float* const tail = reinterpret_cast<float*>(ring + s * sbytes + kW * row_bytes);
#pragma unroll
        for (int i = 0; i < kW; i += 4) {
          *reinterpret_cast<float4*>(tail + i) =
              make_float4(cur.scale[i], cur.scale[i + 1], cur.scale[i + 2], cur.scale[i + 3]);
          *reinterpret_cast<float4*>(tail + kW + i) =
              make_float4(cur.second[i], cur.second[i + 1], cur.second[i + 2], cur.second[i + 3]);
        }
        *reinterpret_cast<int2*>(tail + 2 * kW) =
            make_int2(cur.at.col0, cur.at.live | cur.at.live2 << 8);
        if (cur.at.live > 0) {
          mbar_expect_tx(full + 8 * s, cur.at.live * row_bytes);
          bulk_copy(smem_addr(ring + s * sbytes), rows + cur.at.row0 * row_bytes,
                    cur.at.live * row_bytes, full + 8 * s);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
      cur = ahead;
    }
    return;
  }

  // A consumer: warp g * kW + w owns slot s0 + w (and, with two folds, slot
  // s0 + w + gap) for the queries of group g and walks the block's steps.
  const int w = warp % kW;
  const int qbase = warp / kW * (kNT * 8);
  const int slot = s0 + w;
  float* const scores = reinterpret_cast<float*>(warps_smem + warp * kWarpSmem);
  StepTail* const tails = reinterpret_cast<StepTail*>(scores + kMmaSteps * kScoreStride);
  const int r = lane >> 2;  // the A / C fragment's step of an m-tile (and step + 8)
  const int c = lane & 3;   // its column pair
  // Fold f, pass p: bank[f * kPasses + p]. One-dimensional on purpose: as
  // bank[kF][kPasses], nvcc left the second row without SlotBank's
  // default member initialisers (its banks started at 0, not -1e30).
  SlotBank<kKeep2> bank[kF * kPasses];
  Acc acc[kF * kMT][kNT][4];

  for (int u0 = 0; u0 < nb; u0 += kSteps) {
    // Lane l waits for step u0 + l and takes this slot's part of its tail.
    StepTail mine[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) mine[f] = StepTail{-1, 0.f};
    const bool has_step = lane < kSteps && u0 + lane < nb;
    if (has_step) {
      const int u = u0 + lane;
      mbar_wait(full + 8 * (u % kRing), static_cast<unsigned>(u / kRing) & 1u);
      const float* const tail =
          reinterpret_cast<const float*>(ring + u % kRing * sbytes + kW * row_bytes);
      const int2 at = *reinterpret_cast<const int2*>(tail + 2 * kW);  // first column, live rows
      if (w < (at.y & 0xff) && (kF == 2 || !kAlive || tail[kW + w] > 0.f))
        mine[0] = StepTail{at.x + w, (a.scales ? tail[w] : 1.f) * a.scale_mul};
      if constexpr (kF == 2)
        if (w < at.y >> 8) mine[1] = StepTail{at.x + gap + w, tail[kW + w] * a.scale_mul};
    }
    if (lane < kSteps) {
#pragma unroll
      for (int f = 0; f < kF; ++f) tails[f * kGroupSteps + lane] = mine[f];
    }
    // A second fold is live only where the first is.
    const bool any = __ballot_sync(0xffffffffu, mine[0].col >= 0) != 0u;
    __syncwarp();
    if (any) {
#pragma unroll
      for (int t = 0; t < kF * kMT; ++t)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = Acc(0);
      // The rows of this warp's slot at steps r and r + 8 of each m-tile.
      const char* ar[2 * kMT];
#pragma unroll
      for (int t = 0; t < 2 * kMT; ++t)
        ar[t] = ring + (u0 + 8 * t + r) % kRing * sbytes + w * row_bytes;
      op.template products<kNT, kMT>(acc, ar, smem_addr(tile), qbase, lane);
    }
    __syncwarp();  // the group's rows and tails are read: release its stages
    if (has_step) mbar_arrive(empty + 8 * ((u0 + lane) % kRing));
    if (!any) continue;
    // The m-tiles' scores, fold by fold, go through the one 16-step score
    // tile in turn, so each slot's fold stays in step order.
#pragma unroll
    for (int t = 0; t < kMT; ++t) {
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const StepTail* const tt = tails + f * kGroupSteps + kMmaSteps * t;
        const StepTail t0 = tt[r], t8 = tt[r + 8];
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
#pragma unroll
          for (int jj = 0; jj < 4 && 4 * p + jj < kNT; ++jj) {
            const Acc* const cc = acc[kF * t + f][4 * p + jj];
            // One rounding of the dot (an integer dot's only one), then the
            // scale, as scan_kernel.
            const float2 lo = t0.col >= 0 ? make_float2(static_cast<float>(cc[0]) * t0.mul,
                                                        static_cast<float>(cc[1]) * t0.mul)
                                          : make_float2(kNegInf, kNegInf);
            const float2 hi = t8.col >= 0 ? make_float2(static_cast<float>(cc[2]) * t8.mul,
                                                        static_cast<float>(cc[3]) * t8.mul)
                                          : make_float2(kNegInf, kNegInf);
            *reinterpret_cast<float2*>(scores + r * kScoreStride + 8 * jj + 2 * c) = lo;
            *reinterpret_cast<float2*>(scores + (r + 8) * kScoreStride + 8 * jj + 2 * c) = hi;
          }
          __syncwarp();
#pragma unroll
          for (int st = 0; st < kMmaSteps; ++st)
            bank[f * kPasses + p].fold(scores[st * kScoreStride + lane], tt[st].col);
          __syncwarp();
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kF; ++f)
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int qq = qbase + kFoldQ * p + lane;
      if (kFoldQ * p + lane < kNT * 8 && qq < nq) {
        long long row;  // the bank row: a gathered walk names it
        if constexpr (kGathered)
          row = walk.out_row(it, qq);
        else
          row = it + qq;
        bank[f * kPasses + p].store(a.v, a.i, a.v2, a.i2, row * a.n_slots + slot + f * gap);
      }
    }
}

template <class Op, int kW, int kNT, int kG, int kMT, class Walk, bool kKeep2, bool kAlive>
cudaError_t launch_mma_scan(const Op& op, const Walk& walk, const ScanArgs& a,
                            cudaStream_t stream) {
  constexpr int kTileQ = kNT * 8 * kG;
  auto kernel = mma_scan_kernel<Op, kW, kNT, kG, kMT, Walk, kKeep2, kAlive>;
  const size_t smem = op.tile_bytes(kTileQ) +
                      (size_t)mma_ring<Op, kW, kG, kMT>(kTileQ) * (kW * op.row_bytes() + Op::kTail + 16) +
                      kW * kG * warp_smem(Op::kFolds);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int rows = (a.n_q + kMmaTileQ - 1) / kMmaTileQ;
  if constexpr (GatheredWalk<Walk>::value) rows = walk.n_items;
  const dim3 grid(a.n_slots / (kW * Op::kFolds), rows);
  kernel<<<grid, (kW * kG + 1) * 32, smem, stream>>>(op, walk, a);
  return cudaGetLastError();
}

// n_slots must be a multiple of kW * Op::kFolds.
template <class Op, int kW, int kNT, int kG, int kMT, class Walk>
cudaError_t launch_mma_flags(const Op& op, const Walk& walk, const ScanArgs& a, bool keep2,
                             cudaStream_t stream) {
  if constexpr (Op::kFolds == 1) {
    if (a.alive)
      return keep2 ? launch_mma_scan<Op, kW, kNT, kG, kMT, Walk, true, true>(op, walk, a, stream)
                   : launch_mma_scan<Op, kW, kNT, kG, kMT, Walk, false, true>(op, walk, a, stream);
  } else if (a.alive) {
    return cudaErrorInvalidValue;
  }
  return keep2 ? launch_mma_scan<Op, kW, kNT, kG, kMT, Walk, true, false>(op, walk, a, stream)
               : launch_mma_scan<Op, kW, kNT, kG, kMT, Walk, false, false>(op, walk, a, stream);
}

// The non-exact float scan of a walk (bf16 inputs, f32 accumulate) on the
// tensor-core body, with the fewest n-tiles that hold the batch (up to 128
// queries a tile; a lone query takes the 16-query tile: on the H100 it beat
// the SIMT one-query walk, K1 bf16 rows 0.53 -> 0.31 ms at 1M x 384, PERF.md
// section 6). Needs d % 16 == 0, d <= 384, n_slots % 8 == 0 and 16-byte
// aligned rows.
template <class Rows, class Walk>
cudaError_t launch_bf16_scan(const float* q, const void* db, int d, const Walk& walk,
                             const ScanArgs& a, bool keep2, cudaStream_t stream) {
  using Op = MmaTileOp<Rows>;
  constexpr int kW = Rows::kWarps;
  const Op op{q, db, d};
  if (a.n_q <= 16) return launch_mma_flags<Op, kW, 2, 1, 1>(op, walk, a, keep2, stream);
  if (a.n_q <= 32) return launch_mma_flags<Op, kW, 4, 1, 1>(op, walk, a, keep2, stream);
  if (a.n_q <= 64) return launch_mma_flags<Op, kW, 8, 1, 1>(op, walk, a, keep2, stream);
  return launch_mma_flags<Op, kW, 16, 1, 1>(op, walk, a, keep2, stream);
}

}  // namespace memex
