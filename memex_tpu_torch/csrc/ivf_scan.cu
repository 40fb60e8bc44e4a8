// Per-query IVF probe scan (Hopper, sm_90a): K7, the IVF tier's scan where
// the batch-union kernel (K5) cannot take the bucket (more than 256 chunks
// of 1,024 rows: an index with few clusters over many rows).
//
// Replaces memex_tpu/ops/ivf_scan.py::_kernel_manual (wrapper
// ivf_probe_topk). Strict per-query IVF: query q walks its own nprobe
// clusters in probe order (routing's top-k order), and within each the
// whole bucket in chunks g = 0 .. M/S - 1; row g * S + s of probe p is
// scored, times its scale (int8 rows), masked past the cluster's size and
// folded into slot s with index cid * M + row. Single winner per slot (no
// keep2, no exact mode), S = 256 by default. Arithmetic as the TPU kernel:
// bf16 query against bf16 rows (float32 rows rounded to bf16, int8 codes
// exact), f32 accumulate, then the scale.
//
// The TPU kernel gives each query its own grid step, because its VMEM held
// one query's cluster; on this card that reads every probed bucket once per
// query that probed it, Q times the table where every query probes every
// cluster. Here each probed bucket is read once for all the queries that
// probed it:
//   1. A work list, built on the device by three small kernels (below; its
//      plain version is ops/ivf_scan.py::probe_work_list): the (query,
//      rank) pairs e = q * nprobe + rank grouped by cluster in ascending e
//      (a fixed function of the probes, no atomics), cut into tiles of at
//      most T queries; each tile's cluster has its live chunks cut into R
//      contiguous ranges. An item is (tile, range): block row y = tile * R
//      + range of the grid. The grid is sized from an upper bound of the
//      tile count, so the host never waits for the list; blocks past its
//      end leave at once.
//   2. slot_bank.cuh's tensor-core body (MmaTileOp, K1's and K5's bf16
//      product, for float32, bf16 and int8 rows) scores an item once for its
//      whole tile: the tile is gathered from the item's queries, and the
//      bank of each (query, rank, range) is stored as its own partial bank,
//      row e * R + range of [Q * nprobe * R, S].
//   3. merge_kernel folds each query's nprobe * R partial banks in (rank,
//      range) order with strict '>'. The TPU's fold is a single-winner fold
//      over (rank, chunk) in that order; split into contiguous pieces, each
//      piece's winner is the earliest of its best, and a later piece
//      displaces an earlier one only by a larger score, so the merge is that
//      fold bit for bit (ties included). A piece with no row, (-1e30, 0),
//      never displaces. This merge is exact only because K7 has no keep2:
//      the other scans keep one warp on a slot's whole walk.
//
// What bounds it: the probed buckets' live rows, read once per tile (once
// per batch where a cluster's queries fit one tile), D + 4 bytes a row for
// int8, against 2 * D bf16 products per (query, probed row); the partial
// banks add Q * nprobe * R * S * 8 bytes, written once and read once. On
// an index with few clusters (the 1M-row, 4-cluster index: M = 315,392)
// the bytes are 0.41 GB, 0.12 ms, at every Q. Items there are long, and R
// cuts them so the grid fills the card at Q = 1. K7 takes only buckets of
// more than 256 chunks of 1,024 rows (IVFIndex._scan sends the rest to
// K5), so every item it gets has hundreds of steps for its block's set-up.

#include "slot_bank.cuh"

namespace {

// What a block row walks: `nq` pairs from pairs[off] on (0 past the list),
// chunks [g0, g1) of cluster cid, which holds `size` rows; `range` is the
// item's range index.
struct ProbeItem {
  int cid = 0, size = 0, off = 0, nq = 0, g0 = 0, g1 = 0, range = 0;
};

// The probe-shared walk of the tensor-core body (slot_bank.cuh,
// GatheredWalk): step u of the slot group whose first slot is s0 reads rows
// (g0 + u) * S + s0 ... of the item's cluster, a live prefix of them.
struct ProbeTileWalk {
  using Item = ProbeItem;
  const int* pairs;   // [n_q * nprobe] q * nprobe + rank, grouped by cluster
  const int* tiles;   // [3, n_tiles]: cluster, first pair, pairs (0 past the list)
  const int* sizes;   // [C] rows per cluster
  int n_tiles, ranges, nprobe, m, s;
  int n_items;        // n_tiles * ranges: block rows of the grid

  __device__ __forceinline__ Item item(int y) const {
    Item it;
    const int t = y / ranges;
    it.nq = tiles[2 * n_tiles + t];
    if (it.nq <= 0) return it;
    it.range = y - t * ranges;
    it.cid = tiles[t];
    it.off = tiles[n_tiles + t];
    it.size = sizes[it.cid];
    // The cluster's chunks that hold a row, cut into `ranges` pieces.
    const int live = (it.size + s - 1) / s;
    it.g0 = static_cast<int>((long long)live * it.range / ranges);
    it.g1 = static_cast<int>((long long)live * (it.range + 1) / ranges);
    return it;
  }
  __device__ __forceinline__ int queries(const Item& it) const { return it.nq; }
  __device__ __forceinline__ int query(const Item& it, int qq) const {
    return pairs[it.off + qq] / nprobe;
  }
  __device__ __forceinline__ long long out_row(const Item& it, int qq) const {
    return (long long)pairs[it.off + qq] * ranges + it.range;
  }
  // Chunks g of [g0, g1) where row g * S + s0 is below the cluster's size.
  __device__ __forceinline__ long long steps(int s0, const Item& it) const {
    const int end = it.size > s0 ? (it.size - s0 + s - 1) / s : 0;
    const int n = min(it.g1, end) - it.g0;
    return n > 0 ? n : 0;
  }
  __device__ __forceinline__ memex::BlockStep block_step(int s0, const Item& it, long long u,
                                                         int w) const {
    const int base = (it.g0 + static_cast<int>(u)) * s + s0;
    const long long col0 = (long long)it.cid * m + base;
    const int left = it.size - base;
    return {col0, static_cast<int>(col0), left <= 0 ? 0 : (left < w ? left : w), 0};
  }
};

// Bank row q (slot t % S) folds partial rows q * parts ... in order: rank
// major, then range. kBatch loads in flight a thread before their folds.
__global__ void merge_kernel(const float* part_v, const int* part_i, float* out_v, int* out_i,
                             int n_q, int parts, int n_slots) {
  constexpr int kBatch = 16;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_q * n_slots) return;
  const long long q = t / n_slots;
  const long long base = q * parts * n_slots + (t - q * n_slots);
  memex::SlotBank<false> bank;
  for (int j0 = 0; j0 < parts; j0 += kBatch) {
    float v[kBatch];
    int i[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const bool in = j0 + k < parts;
      v[k] = in ? part_v[base + (long long)(j0 + k) * n_slots] : memex::kNegInf;
      i[k] = in ? part_i[base + (long long)(j0 + k) * n_slots] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) bank.fold(v[k], i[k]);
  }
  out_v[t] = bank.best_v;
  out_i[t] = bank.best_i;
}

// -- The work list (ops/ivf_scan.py::probe_work_list is its plain version) --
//
// Three small kernels, no atomics: a warp for each cluster counts the pairs
// that probed it with a ballot for every 32 pairs; one block scans the
// counts into each cluster's first pair and first tile; a warp for each
// cluster then writes its tiles and, ballot by ballot in ascending e, its
// pairs. Built by PyTorch operations (a sort and a dozen more) the list
// cost 0.3-0.8 ms of host time a call on the H100's host, more than the
// scan (scan_bench list_ms, PERF.md section 6).

constexpr int kListWarps = 8;  // warps a block of the per-cluster passes

__global__ void list_count_kernel(const int* probes, int n_pairs, int n_clusters, int* count) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_clusters) return;
  int n = 0;
  for (int e0 = 0; e0 < n_pairs; e0 += 32) {
    const int e = e0 + lane;
    n += __popc(__ballot_sync(0xffffffffu, e < n_pairs && probes[e] == c));
  }
  if (lane == 0) count[c] = n;
}

// One block of 1,024 threads: thread i sums a contiguous run of clusters,
// the block scans those sums, and each thread writes its run's first pair
// and first tile; the tiles past the list's end get (n_pairs, n_pairs, 0).
__global__ void list_scan_kernel(const int* count, int n_clusters, int n_pairs, int tile_q,
                                 int n_tiles, int* first, int* tile0, int* tiles) {
  __shared__ int sum_p[1024], sum_t[1024];
  const int i = threadIdx.x;
  const int per = (n_clusters + blockDim.x - 1) / blockDim.x;
  const int c0 = min(i * per, n_clusters), c1 = min(c0 + per, n_clusters);
  int np = 0, nt = 0;
  for (int c = c0; c < c1; ++c) {
    np += count[c];
    nt += (count[c] + tile_q - 1) / tile_q;
  }
  sum_p[i] = np;
  sum_t[i] = nt;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off *= 2) {  // inclusive scan, Hillis-Steele
    const int ap = i >= off ? sum_p[i - off] : 0, at = i >= off ? sum_t[i - off] : 0;
    __syncthreads();
    sum_p[i] += ap;
    sum_t[i] += at;
    __syncthreads();
  }
  int p = sum_p[i] - np, t = sum_t[i] - nt;
  for (int c = c0; c < c1; ++c) {
    first[c] = p;
    tile0[c] = t;
    p += count[c];
    t += (count[c] + tile_q - 1) / tile_q;
  }
  for (int j = sum_t[blockDim.x - 1] + i; j < n_tiles; j += blockDim.x) {
    tiles[j] = n_pairs;
    tiles[n_tiles + j] = n_pairs;
    tiles[2 * n_tiles + j] = 0;
  }
}

__global__ void list_fill_kernel(const int* probes, int n_pairs, int n_clusters, int tile_q,
                                 int n_tiles, const int* count, const int* first,
                                 const int* tile0, int* pairs, int* tiles) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_clusters) return;
  const int n = count[c];
  if (n == 0) return;
  const int f = first[c], t0 = tile0[c];
  for (int j = lane; j * tile_q < n; j += 32) {
    tiles[t0 + j] = c;
    tiles[n_tiles + t0 + j] = f + j * tile_q;
    tiles[2 * n_tiles + t0 + j] = min(tile_q, n - j * tile_q);
  }
  for (int e0 = 0, done = 0; e0 < n_pairs && done < n; e0 += 32) {
    const int e = e0 + lane;
    const bool mine = e < n_pairs && probes[e] == c;
    const unsigned hits = __ballot_sync(0xffffffffu, mine);
    if (mine) pairs[f + done + __popc(hits & ((1u << lane) - 1u))] = e;
    done += __popc(hits);
  }
}

cudaError_t build_list(const int* probes, int n_pairs, int n_clusters, int tile_q, int n_tiles,
                       int* scratch, int* pairs, int* tiles, cudaStream_t s) {
  int* const count = scratch;
  int* const first = scratch + n_clusters;
  int* const tile0 = scratch + 2 * n_clusters;
  const int blocks = (n_clusters + kListWarps - 1) / kListWarps;
  list_count_kernel<<<blocks, 32 * kListWarps, 0, s>>>(probes, n_pairs, n_clusters, count);
  list_scan_kernel<<<1, 1024, 0, s>>>(count, n_clusters, n_pairs, tile_q, n_tiles, first, tile0,
                                      tiles);
  list_fill_kernel<<<blocks, 32 * kListWarps, 0, s>>>(probes, n_pairs, n_clusters, tile_q,
                                                      n_tiles, count, first, tile0, pairs, tiles);
  return cudaGetLastError();
}

// The body with the fewest n-tiles that hold a tile of tile_q queries.
template <class Rows>
cudaError_t launch_items(const float* q, const void* data, int d, const ProbeTileWalk& w,
                         const memex::ScanArgs& a, int tile_q, cudaStream_t s) {
  using Op = memex::MmaTileOp<Rows>;
  constexpr int kW = Rows::kWarps;
  const Op op{q, data, d};
  switch (tile_q) {
    case 16: return memex::launch_mma_scan<Op, kW, 2, 1, 1, ProbeTileWalk, false, false>(op, w, a, s);
    case 32: return memex::launch_mma_scan<Op, kW, 4, 1, 1, ProbeTileWalk, false, false>(op, w, a, s);
    case 64: return memex::launch_mma_scan<Op, kW, 8, 1, 1, ProbeTileWalk, false, false>(op, w, a, s);
    case 128: return memex::launch_mma_scan<Op, kW, 16, 1, 1, ProbeTileWalk, false, false>(op, w, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The largest row dim K7 takes; the Python wrapper checks it.
int memex_ivf_probe_max_dim() { return memex::kMmaMaxDim; }

// K7's work list from probes [n_pairs] (n_q * nprobe cluster ids < n_clusters,
// row-major): pairs [n_pairs] and tiles [3, n_tiles] int32 as
// ops/ivf_scan.py::probe_work_list makes them; scratch [3 * n_clusters]
// int32. n_tiles must bound the tile count. Returns the first failed
// launch's cudaError_t.
int memex_ivf_probe_list(const int* probes, int n_pairs, int n_clusters, int tile_q, int n_tiles,
                         int* scratch, int* pairs, int* tiles, void* stream) {
  if (n_pairs <= 0 || n_clusters <= 0 || tile_q <= 0 || n_tiles <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)build_list(probes, n_pairs, n_clusters, tile_q, n_tiles, scratch, pairs, tiles,
                         static_cast<cudaStream_t>(stream));
}

// q [n_q, d] f32; data [C, m, d] rows of row_type 0 (float32), 1 (bf16) or
// 2 (int8); scales [C, m] f32 for int8 rows, else null; sizes [C] int32;
// probes [n_q, nprobe] int32. Builds the work list (tiles of at most tile_q
// = 16, 32, 64 or 128 pairs, n_tiles of them at most, into the int32
// scratch [3 * C + n_q * nprobe + 3 * n_tiles]), cuts each cluster's chunks
// into `ranges`, runs the scan into part_v/part_i
// [n_q * nprobe * ranges, n_slots], then the merge into out_v/out_i
// [n_q, n_slots], all on `stream`. Returns the first failed launch's
// cudaError_t (0 on success).
int memex_ivf_probe(const float* q, const void* data, int row_type, const float* scales,
                    const int* sizes, const int* probes, int n_clusters, int tile_q, int n_tiles,
                    int ranges, int* scratch, float* part_v, int* part_i,
                    float* out_v, int* out_i, int n_q, int nprobe, int d, int n_slots, int m,
                    void* stream) {
  if (n_q <= 0 || nprobe <= 0 || d <= 0 || d % 16 || d > memex::kMmaMaxDim || n_slots <= 0 ||
      n_slots % 8 || m <= 0 || m % n_slots || row_type < 0 || row_type > 2 ||
      (row_type == 2) != (scales != nullptr) || n_clusters <= 0 || n_tiles <= 0 ||
      ranges <= 0 || (long long)n_tiles * ranges > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pairs = n_q * nprobe;
  int* const pairs = scratch + 3 * n_clusters;
  int* const tiles = pairs + n_pairs;
  cudaError_t err =
      build_list(probes, n_pairs, n_clusters, tile_q, n_tiles, scratch, pairs, tiles, s);
  if (err != cudaSuccess) return (int)err;
  const memex::ScanArgs a{scales, 1.f, nullptr, part_v, part_i, nullptr, nullptr, n_q, n_slots};
  const ProbeTileWalk w{pairs, tiles, sizes, n_tiles, ranges, nprobe, m, n_slots,
                        n_tiles * ranges};
  if (row_type == 2)
    err = launch_items<memex::Int8Rows>(q, data, d, w, a, tile_q, s);
  else if (row_type == 1)
    err = launch_items<memex::Bf16Rows>(q, data, d, w, a, tile_q, s);
  else
    err = launch_items<memex::F32Rows>(q, data, d, w, a, tile_q, s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)n_q * n_slots;
  merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      part_v, part_i, out_v, out_i, n_q, nprobe * ranges, n_slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
