// Batch-union IVF scan over the packed int4 mirror (Hopper, sm_90a): K6,
// the coarse scan of `scan_int4` IVF stores.
//
// Replaces memex_tpu/ops/ivf_batch4.py::_kernel4 (wrapper ivf_batch_topk4).
// K5's walk (walk[t] = cid * 256 + chunk, t < n_chunks) over a row-pair
// packed table: byte (c, j * S/2 + s, d) is b = 16 * hi + lo, hi the int4
// code of bucket row j * S + s and lo that of row j * S + S/2 + s, both in
// [-7, 7]. Scoring as the TPU kernel (ivf_batch4.py:161-170), bf16 queries
// against exact small integers, FP32 FMA:
//   se = q . hi, hi = (b + 8) >> 4        -> slot s,       row j*S + s
//   so = q . b - 16 * se                  -> slot s + S/2, row j*S + S/2 + s
// (so is not computed as q . lo: the two round differently, and parity is
// with the TPU's arithmetic), each times rscales4 = int8 scale * 16 at its
// row, masked past the cluster's size, folded with index cid * M + row.
//
// One warp owns the slot pair (s, s + S/2) for a tile of queries, so the
// D packed bytes both slots read are loaded once; it walks t ascending,
// which is the TPU's fold order for both slots (strict '>', keep2's
// demotion; no merge). Rows stream through slot_bank.cuh's ring_walk, the
// protocol scan_kernel runs, 8 in flight per warp; what is K6's own is the
// request (one packed row for two slots: the 16-byte tail of a stage holds
// the two row scales, the column of slot s and how many of the pair are
// live) and the pair fold into two banks.
//
// What bounds it: half of K5's int8 bytes, n_chunks * (S/2 * D + 4 * S),
// per 32-query tile, with half as many warps as K5 (one per slot pair); at
// Q >= 32 the float4 query-tile reads from shared memory, two FMAs per
// byte and query.

#include "slot_bank.cuh"

namespace {

using memex::kScanStages;
using memex::kScanWarps;
using Tile = memex::FloatTileOp<memex::Int8x4, true>;  // bf16 queries, packed bytes

struct Args {
  const float* q;       // [n_q, d] f32
  const void* data4;    // [C, m / 2, d] packed rows
  const float* scales;  // [C, m] rscales4
  const int* sizes;     // [C]
  const int* walk;      // [C * m / n_slots]
  const int* n_chunks;  // [1]
  float* v;
  int* i;
  float* v2;
  int* i2;
  int n_q, d, n_slots, m;
};

template <int kT, bool kKeep2>
__global__ void __launch_bounds__(kScanWarps * 32) ivf_batch4_kernel(const Args a) {
  extern __shared__ uint4 smem_raw[];
  char* const tile = reinterpret_cast<char*>(smem_raw);
  const Tile op{reinterpret_cast<const float4*>(a.q), a.data4, a.d / 4};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = a.n_slots / 2;
  const int slot = blockIdx.x * kScanWarps + warp;  // and slot + half
  const int q0 = blockIdx.y * kT;
  const int nq = min(kT, a.n_q - q0);
  const int row_bytes = op.row_bytes();
  const int sbytes = memex::stage_bytes(row_bytes);
  char* const ring = tile + op.tile_bytes(kT) + warp * kScanStages * sbytes;
  const char* const rows = static_cast<const char*>(a.data4);
  const long long n = *a.n_chunks;

  // Tail of a stage: scale of each row of the pair, the column of slot s,
  // and the live rows of the pair (0: masked, nothing copied; 1: the first
  // only; 2: both).
  auto request = [&](int s, long long t) {
    char* dst = ring + s * sbytes;
    int live = 0, col = 0;
    if (t < n) {
      const int w = a.walk[t];
      const int cid = w >> 8;
      const int j = w & 255;
      const int row = j * a.n_slots + slot;
      const int size = a.sizes[cid];
      live = row < size ? (row + half < size ? 2 : 1) : 0;
      col = cid * a.m + row;
      if (live) {
        memex::copy_row(
            dst, rows + ((long long)cid * (a.m / 2) + (long long)j * half + slot) * row_bytes,
            row_bytes, lane);
        if (lane == 31) memex::cp_async4(dst + row_bytes, a.scales + col);
        if (live == 2 && lane == 30) memex::cp_async4(dst + row_bytes + 4, a.scales + col + half);
      }
    }
    if (lane == 0) {
      reinterpret_cast<int*>(dst + row_bytes)[2] = col;
      reinterpret_cast<int*>(dst + row_bytes)[3] = live;
    }
    memex::cp_async_commit();
  };

  struct Step {
    Tile::Row r;
    float scale_e, scale_o;
    int col, live;
  };
  memex::SlotBank<kKeep2> bank_e, bank_o;
  const float4* qs = reinterpret_cast<const float4*>(tile) + lane;
  memex::ring_walk<Step>(
      ring, sbytes, n, request, [&] { op.template stage<kT>(tile, q0, nq); },
      [&](const char* st, Step& t) {
        const float* tail = reinterpret_cast<const float*>(st + row_bytes);
        t.scale_e = tail[0];
        t.scale_o = tail[1];
        t.col = reinterpret_cast<const int*>(tail)[2];
        t.live = reinterpret_cast<const int*>(tail)[3];
        if (t.live) op.read(st, lane, t.r);
        return t.live != 0;
      },
      [&](const Step& t) {
        float b[Tile::kUnits][4], h[Tile::kUnits][4];
#pragma unroll
        for (int j = 0; j < Tile::kUnits; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int x = static_cast<int>(t.r.u[j] << (24 - 8 * k)) >> 24;  // signed byte k
            b[j][k] = static_cast<float>(x);
            h[j][k] = static_cast<float>((x + 8) >> 4);
          }
        }
        float pe[kT], pr[kT];
#pragma unroll
        for (int qq = 0; qq < kT; ++qq) {
          float ae = 0.f, ar = 0.f;
#pragma unroll
          for (int j = 0; j < Tile::kUnits; ++j) {
            const float4 qv = qs[qq * Tile::kTileUnits + 32 * j];
            ae = fmaf(h[j][0], qv.x, ae);
            ae = fmaf(h[j][1], qv.y, ae);
            ae = fmaf(h[j][2], qv.z, ae);
            ae = fmaf(h[j][3], qv.w, ae);
            ar = fmaf(b[j][0], qv.x, ar);
            ar = fmaf(b[j][1], qv.y, ar);
            ar = fmaf(b[j][2], qv.z, ar);
            ar = fmaf(b[j][3], qv.w, ar);
          }
          pe[qq] = ae;
          pr[qq] = ar;
        }
        memex::reduce_tile<kT>(pe, lane);
        memex::reduce_tile<kT>(pr, lane);
        const float se = pe[0];
        bank_e.fold(se * t.scale_e, t.col);
        if (t.live == 2) bank_o.fold((pr[0] - 16.f * se) * t.scale_o, t.col + half);
      });
  if (lane < nq) {
    const long long o = (long long)(q0 + lane) * a.n_slots + slot;
    bank_e.store(a.v, a.i, a.v2, a.i2, o);
    bank_o.store(a.v, a.i, a.v2, a.i2, o + half);
  }
}

template <int kT, bool kKeep2>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = ivf_batch4_kernel<kT, kKeep2>;
  const Tile op{nullptr, nullptr, a.d / 4};
  const size_t smem =
      op.tile_bytes(kT) + (size_t)kScanWarps * kScanStages * memex::stage_bytes(op.row_bytes());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_slots / 2 / kScanWarps, (a.n_q + kT - 1) / kT);
  kernel<<<grid, kScanWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest row dim K6 takes; the Python wrapper checks it.
int memex_ivf_batch4_max_dim() { return Tile::kMaxDim; }

// q [n_q, d] f32; data4 [C, m / 2, d] row-pair packed int8; rscales4 [C, m]
// f32; sizes [C], walk [C * m / n_slots] and n_chunks [1] int32 on the
// device; out_v/out_i [n_q, n_slots] (and out_v2/out_i2 when keep2).
// Returns the launch's cudaError_t (0 on success).
int memex_ivf_batch4(const float* q, const void* data4, const float* rscales4, const int* sizes,
                     const int* walk, const int* n_chunks, float* out_v, int* out_i,
                     float* out_v2, int* out_i2, int n_q, int d, int n_slots, int m, int keep2,
                     void* stream) {
  if (n_q <= 0 || d <= 0 || d % 16 || d > Tile::kMaxDim || n_slots <= 0 ||
      n_slots % (2 * kScanWarps) || m <= 0 || m % n_slots)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args args{q, data4, rscales4, sizes, walk, n_chunks, out_v, out_i, out_v2, out_i2,
                  n_q, d, n_slots, m};
  if (n_q == 1)
    return (int)(keep2 ? launch<1, true>(args, s) : launch<1, false>(args, s));
  return (int)(keep2 ? launch<memex::kQT, true>(args, s) : launch<memex::kQT, false>(args, s));
}

}  // extern "C"
