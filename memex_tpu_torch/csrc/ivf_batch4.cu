// Batch-union IVF scan over the packed int4 mirror (Hopper, sm_90a): K6,
// the coarse scan of `scan_int4` IVF stores.
//
// Replaces memex_tpu/ops/ivf_batch4.py::_kernel4 (wrapper ivf_batch_topk4).
// K5's walk (walk[t] = cid * 256 + chunk, t < n_chunks) over a row-pair
// packed table: byte (c, j * S/2 + s, d) is b = 16 * hi + lo, hi the int4
// code of bucket row j * S + s and lo that of row j * S + S/2 + s, both in
// [-7, 7]. Scoring as the TPU kernel (ivf_batch4.py:161-170), bf16 queries
// against exact small integers, f32 accumulate:
//   se = q . hi, hi = (b + 8) >> 4        -> slot s,       row j*S + s
//   so = q . b - 16 * se                  -> slot s + S/2, row j*S + S/2 + s
// (so is not computed as q . lo: the two round differently, and parity is
// with the TPU's arithmetic), each times rscales4 = int8 scale * 16 at its
// row, masked past the cluster's size, folded with index cid * M + row.
//
// K6 runs slot_bank.cuh's tensor-core body (mma_scan_kernel) at every batch
// size, with two folds a step: a consumer warp owns the slot
// pair (s, s + S/2), so the D packed bytes both slots read are loaded once,
// and walks t ascending, the TPU's fold order for both slots (strict '>',
// keep2's demotion; no merge). A block is 4 packed rows a step (8 slots: 128
// blocks at S = 1,024), brought by the producer warp's bulk copies; the
// step's tail carries the scales of both rows of each pair and how many
// first and second rows are live (both prefixes along s). From each packed
// word a lane makes two bf16 A fragments without the conversion pipe: b by
// placing the byte b + 128 under the exponent of 2^23, and hi by placing
// hi + 8 = ((b + 128) >> 4) + (((b + 128) >> 3) & 1), four bytes at a time,
// under the exponent of 2^7 in bf16 (both exact small integers, for every
// byte value). One B fragment read (ldmatrix of the bf16 query tile) serves
// both chains of mma.sync m16n8k16; the accumulators are se and sraw, and
// so = sraw - 16 se is formed in float32 from the two rounded sums, as the
// TPU kernel and the plain version do. A lane holds a row's bytes 4c .. 4c +
// 3 of each 16, so the tile keeps each 16 query values in the order 0 1 4 5
// 8 9 12 13, 2 3 6 7 10 11 14 15, where ldmatrix then finds them for the
// fragment's pairs. The two accumulator sets double a warp's registers, so a
// warp takes at most 64 queries (two warps a pair past that).
//
// What bounds it: half of K5's int8 bytes, n_chunks * (S/2 * D + 4 * S), once
// per batch of 128, and the unpack: ~50 integer and float operations a lane
// for each 16 x 16 piece of packed bytes, beside 2 * kNT products, so the
// integer pipe, not the tensor cores or the bytes, is the limit up to 64
// queries. Measured on an NVIDIA H100 80GB HBM3 at 700 W on the 10M
// configuration's unions (PERF.md, section 6): 0.07 / 0.79 / 3.89 ms at 1 /
// 32 / 128 queries against bounds of 0.01 / 0.26 / 0.81.

#include "slot_bank.cuh"

namespace {

// -- The tensor-core body's pair product ------------------------------------------

// The bytes n0 .. n3 of x (each at most 127) as two bf16 pairs (n0 - off,
// n1 - off) and (n2 - off, n3 - off), where `bias` holds the bf16 128 + off
// twice: a byte under the high byte 0x43 is the bf16 128 + n, and the
// difference of two integers below 256 is exact in bf16's 8 bits.
__device__ __forceinline__ void bytes_to_bf16x2(uint32_t x, uint32_t bias, uint32_t& p01,
                                                uint32_t& p23) {
  const uint32_t u01 = __byte_perm(x, 0x43434343u, 0x4140);
  const uint32_t u23 = __byte_perm(x, 0x43434343u, 0x4342);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  const __nv_bfloat162 h01 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u01), b);
  const __nv_bfloat162 h23 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u23), b);
  p01 = *reinterpret_cast<const uint32_t*>(&h01);
  p23 = *reinterpret_cast<const uint32_t*>(&h23);
}

// Byte k of x (any value) as a float: under the exponent of 2^23 it is 2^23
// + n, and a float that is a small integer has its bf16 in its top half.
template <int k>
__device__ __forceinline__ uint32_t byte_f32_bits(uint32_t x, float bias) {
  return __float_as_uint(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7440 + k)) - bias);
}

// The A operands of a packed word w (bytes b0 .. b3): b as the bf16 pairs
// (b0, b1), (b2, b3), and hi = (b + 8) >> 4 (an arithmetic shift: floor)
// likewise. With x = b + 128 in [0, 255], hi + 8 = floor((x + 8) / 16) =
// (x >> 4) + ((x >> 3) & 1), in [0, 16]: no carry between bytes, for every
// byte value.
__device__ __forceinline__ void pair_operands(uint32_t w, uint32_t& b01, uint32_t& b23,
                                              uint32_t& h01, uint32_t& h23) {
  const uint32_t x = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  b01 = __byte_perm(byte_f32_bits<0>(x, kBias), byte_f32_bits<1>(x, kBias), 0x7632);
  b23 = __byte_perm(byte_f32_bits<2>(x, kBias), byte_f32_bits<3>(x, kBias), 0x7632);
  const uint32_t h8 = ((x >> 4) & 0x0f0f0f0fu) + ((x >> 3) & 0x01010101u);
  bytes_to_bf16x2(h8, 0x43084308u, h01, h23);  // bf16 136 = 128 + 8
}

// float32 queries against row-pair packed rows of d bytes (d % 16 == 0): the
// tensor-core body's Op with two folds a step. acc[2t] is se and acc[2t + 1]
// so of m-tile t.
struct PairMmaOp {
  using Acc = float;
  static constexpr int kFolds = 2;
  static constexpr int kSlots = 4;  // packed rows a block step: 8 slots a block
  static constexpr int kTail = 48;
  static constexpr int kMaxRowBytes = memex::kMmaMaxDim;
  __host__ __device__ static constexpr int max_tile_bytes(int tq) {
    return tq * (2 * memex::kMmaMaxDim + 16);
  }
  const float* q;  // [n_q, d]
  const void* db;  // packed rows of d bytes
  int d;

  __host__ __device__ int row_bytes() const { return d; }
  __host__ __device__ int tile_stride() const { return 2 * d + 16; }
  __host__ __device__ int tile_bytes(int tq) const { return tq * tile_stride(); }

  // The query tile as bf16, zero rows past nq; pair p of a row's d / 2 holds
  // the values a lane's word bytes meet (see the header).
  __device__ __forceinline__ void stage_tile(char* tile, int q0, int nq, int tq) const {
    const int hd = d / 2;
    const int tstride = tile_stride();
    for (int t = threadIdx.x; t < tq * hd; t += blockDim.x) {
      const int qq = t / hd;
      const int p = t - qq * hd;
      const int in_group = p % 8;  // pair of its group of 16 values
      const int k = 16 * (p / 8) + (in_group < 4 ? 4 * in_group : 4 * (in_group - 4) + 2);
      float2 v = make_float2(0.f, 0.f);
      if (qq < nq) v = *reinterpret_cast<const float2*>(q + (long long)(q0 + qq) * d + k);
      *reinterpret_cast<uint32_t*>(tile + qq * tstride + 4 * p) = memex::bf16x2(v.x, v.y);
    }
  }

  template <int kNT, int kMT>
  __device__ __forceinline__ void products(float (&acc)[2 * kMT][kNT][4],
                                           const char* const (&rows)[2 * kMT], unsigned tile,
                                           int qbase, int lane) const {
    const int tstride = tile_stride();
    const unsigned b_lane = memex::b_lane_addr(tile, tstride, qbase, lane);
    // Packed bytes 4c .. 4c + 3 of each k-step of 16.
    const uint32_t* a[2 * kMT];
#pragma unroll
    for (int t = 0; t < 2 * kMT; ++t) a[t] = reinterpret_cast<const uint32_t*>(rows[t]) + (lane & 3);
#pragma unroll 2
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t ab[kMT][4], ah[kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        pair_operands(a[2 * t][k0 / 4], ab[t][0], ab[t][2], ah[t][0], ah[t][2]);
        pair_operands(a[2 * t + 1][k0 / 4], ab[t][1], ab[t][3], ah[t][1], ah[t][3]);
      }
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
        memex::ldmatrix_x4(bf[j], b_lane + j * 16 * tstride + 2 * k0);
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j)
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          memex::mma_bf16(acc[2 * t][2 * j], ah[t], bf[j][0], bf[j][1]);
          memex::mma_bf16(acc[2 * t][2 * j + 1], ah[t], bf[j][2], bf[j][3]);
          memex::mma_bf16(acc[2 * t + 1][2 * j], ab[t], bf[j][0], bf[j][1]);
          memex::mma_bf16(acc[2 * t + 1][2 * j + 1], ab[t], bf[j][2], bf[j][3]);
        }
    }
    // so = sraw - 16 se, from the two rounded sums (16 se is exact).
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * t + 1][j][e] -= 16.f * acc[2 * t][j][e];
  }
};

// K5's chunk walk over packed rows: step t of the w slot pairs from s0 on
// reads packed rows (walk[t] & 255) * S/2 + s0 ... of cluster walk[t] >> 8;
// their first rows are bucket rows (walk[t] & 255) * S + s0 ..., their
// second rows S/2 further, each live below the cluster's size.
struct PairChunkWalk {
  const int* walk;      // [C * M / S] packed (cluster, chunk), in walk order
  const int* n_chunks;  // [1] live entries of walk
  const int* sizes;     // [C] rows per cluster
  int m, s;             // bucket rows M, chunk rows S (the bank width)

  __device__ __forceinline__ long long steps(int, int) const { return *n_chunks; }
  __device__ __forceinline__ memex::BlockStep block_step(int s0, int, long long t, int w) const {
    const int wt = walk[t];
    const int cid = wt >> 8;
    const int j = wt & 255;
    const int base = j * s + s0;
    const int left = sizes[cid] - base;
    const int left2 = left - s / 2;
    return {(long long)cid * (m / 2) + (long long)j * (s / 2) + s0, cid * m + base,
            left <= 0 ? 0 : (left < w ? left : w), left2 <= 0 ? 0 : (left2 < w ? left2 : w)};
  }
};


}  // namespace

extern "C" {

// The largest row dim K6 takes; the Python wrapper checks it.
int memex_ivf_batch4_max_dim() { return memex::kMmaMaxDim; }

// q [n_q, d] f32; data4 [C, m / 2, d] row-pair packed int8; rscales4 [C, m]
// f32; sizes [C], walk [C * m / n_slots] and n_chunks [1] int32 on the
// device; out_v/out_i [n_q, n_slots] (and out_v2/out_i2 when keep2).
// Returns the launch's cudaError_t (0 on success).
int memex_ivf_batch4(const float* q, const void* data4, const float* rscales4, const int* sizes,
                     const int* walk, const int* n_chunks, float* out_v, int* out_i,
                     float* out_v2, int* out_i2, int n_q, int d, int n_slots, int m, int keep2,
                     void* stream) {
  constexpr int kW = PairMmaOp::kSlots;
  if (n_q <= 0 || d <= 0 || d % 16 || d > memex::kMmaMaxDim || n_slots <= 0 ||
      n_slots % (2 * kW) || m <= 0 || m % n_slots)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const memex::ScanArgs a{rscales4, 1.f, nullptr, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const PairChunkWalk w{walk, n_chunks, sizes, m, n_slots};
  const PairMmaOp op{q, data4, d};
  const bool k2 = keep2 != 0;
  // The fewest n-tiles a warp that hold the batch, up to 64 queries a warp,
  // in groups of 32 steps; past that, two groups of 64 on warps of their own.
  // Measured on an NVIDIA H100 80GB HBM3 at 700 W, on the 10M shape's unions
  // (S = 1,024), bank ms: a lone query on the
  // 16-query tile 0.06-0.08 ms against 0.14-0.18 on a SIMT one-query walk;
  // 32-step groups 0.75 against 1.08 ms at 32 queries and 1.66-1.69 against
  // 1.97 at 64, no gain at 128 (3.84 against 3.72-3.80); 8 packed rows a
  // block (64 blocks) 1.23 / 6.77 ms at 32 / 128 against 0.76 / 3.75 with 4;
  // two warps of 32 at 64 queries 1.86, four of 32 at 128 5.02.
  if (n_q <= 16) return (int)memex::launch_mma_flags<PairMmaOp, kW, 2, 1, 2>(op, w, a, k2, s);
  if (n_q <= 32) return (int)memex::launch_mma_flags<PairMmaOp, kW, 4, 1, 2>(op, w, a, k2, s);
  if (n_q <= 64) return (int)memex::launch_mma_flags<PairMmaOp, kW, 8, 1, 2>(op, w, a, k2, s);
  return (int)memex::launch_mma_flags<PairMmaOp, kW, 8, 2, 1>(op, w, a, k2, s);
}

}  // extern "C"
