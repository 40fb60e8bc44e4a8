// Per-query IVF probe scan (Hopper, sm_90a): K7, the IVF tier's scan where
// the batch-union kernel (K5) cannot take the bucket.
//
// Replaces memex_tpu/ops/ivf_scan.py::_kernel_manual (wrapper
// ivf_probe_topk). Strict per-query IVF: query q walks its own nprobe
// clusters in probe order (routing's top-k order), and within each the
// whole bucket in chunks g = 0 .. M/S - 1; row g * S + s of probe p is
// scored, times its scale (int8 rows), masked past the cluster's size and
// folded into slot s with index cid * M + row. Single winner per slot,
// S = 256 by default.
//
// K5's slot walk with a per-query walk: one warp owns one (query, slot)
// pair, a one-query tile, and walks u = p * (M / S) + g ascending, which is
// the TPU kernel's fold order (probe loop outside, chunk loop inside), so
// the fold is the TPU's with no merge. Rows past a cluster's size are never
// read. Arithmetic as the TPU kernel: bf16 query against bf16 rows (float32
// rows rounded to bf16, as ivf_scan.py:75-76), FP32 FMA; no exact mode.
//
// What bounds it: every query reads each of its probes' rows, Q * nprobe *
// live rows * (D * itemsize + 4) bytes (no sharing between queries, which
// is what K5 exists to avoid), and with a one-query tile the warps'
// latency: Q * S warps, each keeping 8 rows in flight.

#include "slot_bank.cuh"

namespace {

// Step u of slot s for query q: chunk u % G of probe u / G.
struct ProbeWalk {
  const int* probes;  // [n_q, nprobe] cluster ids in probe order
  const int* sizes;   // [C] rows per cluster
  int nprobe, m, s;   // probes per query, bucket rows M, chunk rows S

  __device__ __forceinline__ long long steps(int, int) const {
    return (long long)nprobe * (m / s);
  }
  __device__ __forceinline__ long long col(int slot, int q, long long u) const {
    const int g_n = m / s;
    const int p = static_cast<int>(u / g_n);
    const int row = static_cast<int>(u - (long long)p * g_n) * s + slot;
    const int cid = probes[(long long)q * nprobe + p];
    return row < sizes[cid] ? (long long)cid * m + row : -1;
  }
};

}  // namespace

extern "C" {

// The largest row dim K7 takes; the Python wrapper checks it.
int memex_ivf_probe_max_dim() { return memex::FloatTileOp<memex::F32x4, true>::kMaxDim; }

// q [n_q, d] f32; data [C, m, d] rows of row_type 0 (float32), 1 (bf16) or
// 2 (int8); scales [C, m] f32 for int8 rows, else null; sizes [C] int32;
// probes [n_q, nprobe] int32; out_v/out_i [n_q, n_slots]. Returns the
// launch's cudaError_t (0 on success).
int memex_ivf_probe(const float* q, const void* data, int row_type, const float* scales,
                    const int* sizes, const int* probes, float* out_v, int* out_i, int n_q,
                    int nprobe, int d, int n_slots, int m, void* stream) {
  if (n_q <= 0 || nprobe <= 0 || d <= 0 || d % 16 || d > memex_ivf_probe_max_dim() ||
      n_slots <= 0 || n_slots % memex::kScanWarps || m <= 0 || m % n_slots || row_type < 0 ||
      row_type > 2 || (row_type == 2) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const memex::ScanArgs a{scales, 1.f, nullptr, out_v, out_i, nullptr, nullptr, n_q, n_slots};
  const ProbeWalk w{probes, sizes, nprobe, m, n_slots};
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // One query per tile: the walk is the query's own.
  if (row_type == 2) {
    using Op = memex::FloatTileOp<memex::Int8x4, true>;
    return (int)memex::launch_scan_tile<Op, ProbeWalk, 1>(Op{q4, data, d / 4}, w, a, false, s);
  }
  if (row_type == 1) {
    using Op = memex::FloatTileOp<memex::Bf16x4, true>;
    return (int)memex::launch_scan_tile<Op, ProbeWalk, 1>(Op{q4, data, d / 4}, w, a, false, s);
  }
  using Op = memex::FloatTileOp<memex::F32x4, true>;
  return (int)memex::launch_scan_tile<Op, ProbeWalk, 1>(Op{q4, data, d / 4}, w, a, false, s);
}

}  // extern "C"
