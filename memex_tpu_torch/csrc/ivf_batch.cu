// Batch-union IVF scan (Hopper, sm_90a): K5, the scan of the IVF tier.
//
// Replaces memex_tpu/ops/ivf_batch.py::_kernel (wrapper ivf_batch_topk).
// The batch's probed clusters (the union, deduplicated by the wrapper's
// routing) are walked chunk by chunk: walk[t] = cid * 256 + chunk for
// t < n_chunks, each chunk S rows of cluster cid's bucket. Row s of chunk t
// is scored against every query, times its row scale (int8 rows), masked
// past the cluster's size, and folded into slot s with index cid * M + row,
// keeping the best (keep2: best two) per slot.
//
// The union is a virtual row space: chunk t's row s is column t * S + s.
// One warp owns one slot and one tile of queries and walks t ascending, so
// each slot sees its candidates in exactly the TPU kernel's order, and the
// fold (strict '>', keep2's demotion) is the TPU's with no merge across
// blocks: K3's slot walk of slot_bank.cuh with the row address (walk[t] >>
// 8, (walk[t] & 255) * S + s). n_chunks stays on the device; each warp
// reads it. Rows past a cluster's size are never read.
//
// Arithmetic, as the TPU kernel: int8 rows are bf16 queries against the
// codes (exact as bf16), f32 accumulate, times the scale (K3's); float32 and
// bf16 rows have both inputs rounded to bf16, f32 accumulate, and no scale;
// `exact` (float32 rows) is FP32 FMA throughout on the SIMT body, so TF32
// never enters.
//
// What bounds it: the union's bytes, at most n_chunks * S * (D * itemsize +
// 4), once per batch, and the products, 2 * Q * D per live row: at the 10M
// configuration (S = 1024, int8) at most 0.51 / 1.14 ms of bytes at Q = 32 /
// 128 against 0.11 / 0.98 ms of bf16 tensor-core flops. The earlier body (FP32
// FMA, 32-query tiles) was bound by its float32 query tile's shared-memory
// reads, 48 KB a row per tile, and read every row once per 32 queries. The
// default modes at Q >= 2 therefore run slot_bank.cuh's tensor-core body
// (up to 128 queries a tile, read as bf16 with ldmatrix once per 16 rows,
// rows brought by a producer warp's bulk copies of a chunk's contiguous
// rows); a lone query keeps the SIMT one-query tile.

#include "slot_bank.cuh"

namespace {

// Step t of slot s: row (walk[t] & 255) * S + s of cluster walk[t] >> 8,
// masked at or past the cluster's size; column cid * M + row is its row in
// the [C * M, D] table and its fold index.
struct ChunkWalk {
  const int* walk;      // [C * M / S] packed (cluster, chunk), in walk order
  const int* n_chunks;  // [1] live entries of walk
  const int* sizes;     // [C] rows per cluster
  int m, s;             // bucket rows M, chunk rows S (the bank width)

  __device__ __forceinline__ long long steps(int, int) const { return *n_chunks; }
  __device__ __forceinline__ long long col(int slot, int, long long t) const {
    const int w = walk[t];
    const int cid = w >> 8;
    const int row = (w & 255) * s + slot;
    return row < sizes[cid] ? (long long)cid * m + row : -1;
  }
  // Step t of the w slots from s0 on: rows (walk[t] & 255) * S + s0 ... of
  // cluster walk[t] >> 8, contiguous; the live ones are a prefix.
  __device__ __forceinline__ memex::BlockStep block_step(int s0, int, long long t, int w) const {
    const int wt = walk[t];
    const int cid = wt >> 8;
    const int base = (wt & 255) * s + s0;
    const long long col0 = (long long)cid * m + base;
    const int left = sizes[cid] - base;
    return {col0, static_cast<int>(col0), left <= 0 ? 0 : (left < w ? left : w), 0};
  }
};

}  // namespace

extern "C" {

// The largest row dim K5 takes; the Python wrapper checks it.
int memex_ivf_batch_max_dim() { return memex::FloatTileOp<memex::F32x4, true>::kMaxDim; }

// q [n_q, d] f32; data [C, m, d] rows of row_type 0 (float32), 1 (bf16) or
// 2 (int8); scales [C, m] f32 for int8 rows, else null; sizes [C] int32;
// walk [C * m / n_slots] int32 and n_chunks [1] int32 on the device;
// out_v/out_i [n_q, n_slots] (and out_v2/out_i2 when keep2). exact applies
// to float32 rows; d % 16 == 0, n_slots % 8 == 0. Returns the launch's
// cudaError_t (0 on success).
int memex_ivf_batch(const float* q, const void* data, int row_type, const float* scales,
                    const int* sizes, const int* walk, const int* n_chunks, float* out_v,
                    int* out_i, float* out_v2, int* out_i2, int n_q, int d, int n_slots, int m,
                    int exact, int keep2, void* stream) {
  if (n_q <= 0 || d <= 0 || d % 16 || d > memex_ivf_batch_max_dim() || n_slots <= 0 ||
      n_slots % 8 || m <= 0 || m % n_slots || row_type < 0 || row_type > 2 ||
      (row_type == 2) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{scales, 1.f, nullptr, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const ChunkWalk w{walk, n_chunks, sizes, m, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k2 = keep2 != 0;
  if (row_type == 2)
    return (int)memex::launch_bf16_scan<memex::Int8x4, memex::Int8Rows>(q, data, d, w, a, k2, s);
  if (row_type == 1)
    return (int)memex::launch_bf16_scan<memex::Bf16x4, memex::Bf16Rows>(q, data, d, w, a, k2, s);
  if (exact) {
    const memex::FloatTileOp<memex::F32x4, false> op{reinterpret_cast<const float4*>(q), data,
                                                     d / 4};
    return (int)memex::launch_scan_flags(op, w, a, k2, s);
  }
  return (int)memex::launch_bf16_scan<memex::F32x4, memex::F32Rows>(q, data, d, w, a, k2, s);
}

}  // extern "C"
