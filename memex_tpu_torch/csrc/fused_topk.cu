// Fused score + slot-bank fold for the flat index scan (Hopper, sm_90a): K1.
//
// Replaces memex_tpu/ops/fused_topk.py::_fused_kernel (with _fold_chunks):
// scores Q queries against N rows and, without writing the [Q, N] score
// matrix anywhere, folds column c into slot c mod S of a per-query bank,
// keeping the slot's best value (keep2: its best two). Columns at or past
// `count`, and rows whose `alive` entry is 0, never enter a slot. The
// caller sorts the [Q, S] (keep2: [Q, 2S]) bank to the top-k.
//
// The scan is slot_bank.cuh's slot walk with the flat walk (slot s folds
// columns s, s + S, s + 2S, ... below min(count, N)), so the fold needs no
// merge across blocks and its tie rule is the TPU kernel's (strict '>':
// the earlier column wins, fused_topk.py:64). Columns past the fill level
// are never read.
//
// What bounds it. The bytes are N * D * 4 for float32 rows (1.5 GB at 1M x
// 384, 0.47 ms at 3.35 TB/s) against 2 * Q * N * D flops, 0.10 ms at Q =
// 128 on bf16 tensor cores, so device memory should bound it. The earlier
// FP32 body did not get there: each lane read its slice of the whole
// float32 query tile from shared memory for every row (48 KB a row for 32
// queries), every product went through the FP32 pipe (67 TFLOP/s: 1.5 ms
// at Q = 128), and a row was read once per 32-query tile. So the default
// modes run the tensor-core body (slot_bank.cuh::mma_scan_kernel): a
// producer warp's bulk copies bring each block step's rows, a 128-query
// bf16 tile is read with ldmatrix once per 16 rows, mma.sync does the
// products, and each row is read once per 128 queries; a lone query takes
// the 16-query tile (the SIMT one-query walk it replaced was bound by its
// warps' latency). What still holds it back at Q = 128 is the consumers'
// mma.sync issue and fold (PERF.md, section 6).
//
// Precision: non-exact mode rounds both inputs to bf16 (round to nearest
// even) and accumulates in f32, as the TPU kernel's bf16 MXU inputs with
// f32 accumulation (tensor cores at every Q); `exact` keeps float32 inputs
// and FP32 FMA throughout on the SIMT body, so TF32 never enters.

#include "slot_bank.cuh"

namespace {

constexpr int kMaxDim = memex::FloatTileOp::kMaxDim;  // 384 (MiniLM)

}  // namespace

extern "C" {

// The largest row dim the kernel takes; the Python wrapper checks it.
int memex_fused_topk_max_dim() { return kMaxDim; }

// q [n_q, d] f32; db [n_rows, d] f32 (db_bf16 = 0) or bf16 (db_bf16 = 1);
// alive [n_rows] f32 or null; out_v/out_i [n_q, n_slots]; out_v2/out_i2
// likewise when keep2, else unused. Columns >= limit = min(count, n_rows)
// are masked. d % 16 == 0, n_slots % 8 == 0. Returns the launch's
// cudaError_t (0 on success).
int memex_fused_topk(const float* q, const void* db, int db_bf16,
                     const float* alive, float* out_v, int* out_i,
                     float* out_v2, int* out_i2, int n_q, int d, int n_slots,
                     long long limit, int exact, int keep2, void* stream) {
  if (n_q <= 0 || d <= 0 || d % 16 || d > kMaxDim || n_slots <= 0 || n_slots % 8)
    return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{nullptr, 1.f, alive, out_v, out_i, out_v2, out_i2, n_q, n_slots};
  const memex::FlatWalk w{limit, n_slots};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k2 = keep2 != 0;
  if (db_bf16)
    return (int)memex::launch_bf16_scan<memex::Bf16Rows>(q, db, d, w, a, k2, s);
  if (exact) {
    const memex::FloatTileOp op{reinterpret_cast<const float4*>(q), db, d / 4};
    return (int)memex::launch_scan_flags(op, w, a, k2, s);
  }
  return (int)memex::launch_bf16_scan<memex::F32Rows>(q, db, d, w, a, k2, s);
}

}  // extern "C"
