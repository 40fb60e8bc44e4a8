"""Per-query IVF probe scan (port of memex_tpu/ops/ivf_scan.py).

Strict per-query IVF: query q scores the whole buckets of its own
`nprobe` clusters, in probe order, and folds bucket row g * S + s of
each into slot s of its bank (single winner, S = banks * 128, 256 by
default). It serves the IVF index where the batch-union scan (K5) cannot
take the bucket (IVFIndex.search's eligibility rule).

The tensor's device picks the implementation: data on the card launches
the hand-written CUDA kernel K7 (csrc/ivf_scan.cu) or raises; data on the
CPU runs the plain PyTorch version, which folds in the same order.

On the card each probed bucket is read once for all the queries that
probed it: `probe_work_list` groups the batch's (query, rank) pairs by
cluster into tiles of queries, the kernel scores each tile against its
cluster's chunks in `R` contiguous ranges into partial banks, one per
(query, rank, range), and merges them in (rank, range) order. For a
single-winner fold with strict '>' that merge gives the one-pass fold bit
for bit (`ivf_probe_partials_reference` and `ivf_probe_merge_reference`
are its plain pieces, for the tests).
"""

from __future__ import annotations

import torch

from .fused_topk import _LANES, NEG_INF, _bank_topk, _fold_bank, _launched
from .fused_topk import _need_cuda, scores_f32
from .ivf_batch import ROW_TYPES, _check_ivf

# The kernel's query tiles (the body's n-tiles of 8 queries, in pairs).
TILE_Q = (16, 32, 64, 128)
# Blocks the grid aims at before the list is known: one for each of the
# H100's 132 SMs (scan_bench, PERF.md section 6: 132 and 264 within the
# spread of two runs, 528 and more slower; each block re-stages its tile).
TARGET_BLOCKS = 132
# The grid's second dimension: one row per (tile, range).
_MAX_ITEMS = 65535


def probe_plan(Q: int, nprobe: int, C: int, M: int, S: int, block_slots: int = 8):
    """(T, n_tiles, R) for a batch, from its shape alone (no host sync):
    T the tile width, twice the mean queries a probed cluster holds (Q *
    nprobe / C), at most the batch; n_tiles an upper bound of the tile
    count (each cluster's last tile may be partial); R the ranges each
    cluster's chunks are cut into, so that the fewest tiles the list can
    have, each S / block_slots blocks wide, fill about TARGET_BLOCKS blocks.
    block_slots: the body's slots a block, 8 (int8 and bf16 rows) or 4
    (float32)."""
    E = Q * nprobe
    want = min(Q, -(-2 * E // C), TILE_Q[-1])
    T = next(t for t in TILE_Q if t >= want)
    n_tiles = min(E, E // T + min(C, E))
    # At least ceil(E / T) tiles, and a query's nprobe probes are distinct.
    fewest = max(-(-E // T), min(nprobe, C))
    R = max(1, min(-(-TARGET_BLOCKS // (S // block_slots * fewest)), M // S,
                   _MAX_ITEMS // max(1, n_tiles)))
    return T, n_tiles, R


def probe_work_list(probes: torch.Tensor, n_clusters: int, tile_q: int, n_tiles: int):
    """K7's work list, without a host sync: on the card three small kernels
    (csrc/ivf_scan.cu, memex_ivf_probe_list), on the CPU this plain version.

    probes [Q, nprobe] cluster ids < n_clusters -> (pairs [Q * nprobe]
    int32: the pairs e = q * nprobe + rank, grouped by cluster in ascending
    id and in ascending e within a cluster (a fixed function of the
    probes); tiles [3, n_tiles] int32: each tile's cluster, first entry of
    `pairs` and pair count, at most tile_q, then (E, E, 0) past the list's
    end). A cluster's pairs fill its tiles in order. `n_tiles` must bound
    the tile count (probe_plan's does)."""
    if probes.is_cuda:
        return _probe_work_list_cuda(probes, n_clusters, tile_q, n_tiles)
    E = probes.numel()
    e = torch.arange(E)
    key = torch.sort(probes.reshape(-1).long() * E + e).values  # distinct keys
    cid = key // E
    pairs = key - cid * E
    new = torch.ones(E, dtype=torch.bool)  # a cluster's first pair
    new[1:] = cid[1:] != cid[:-1]
    pos = e - torch.cummax(torch.where(new, e, 0), 0).values  # place in its cluster
    head = pos % tile_q == 0  # a tile's first pair
    # Heads write their tile; the others write a spare column. A tile's
    # count runs to the next tile's first pair (E past the list).
    t = torch.where(head, torch.cumsum(head, 0) - 1, n_tiles + 1)
    tiles = torch.full((3, n_tiles + 2), E, dtype=torch.int64)
    tiles[0, t] = cid
    tiles[1, t] = e
    tiles[2, :n_tiles] = tiles[1, 1 : n_tiles + 1] - tiles[1, :n_tiles]
    return pairs.to(torch.int32), tiles[:, :n_tiles].to(torch.int32)


def _probe_work_list_cuda(probes, n_clusters: int, tile_q: int, n_tiles: int):
    from ..kernels import library

    if probes.dtype != torch.int32:
        raise TypeError("probes must be int32")
    probes = probes.contiguous()
    _need_cuda(probes)
    E = probes.numel()
    with torch.cuda.device(probes.device):
        scratch = torch.empty(3 * n_clusters, dtype=torch.int32, device=probes.device)
        pairs = torch.empty(E, dtype=torch.int32, device=probes.device)
        tiles = torch.empty((3, n_tiles), dtype=torch.int32, device=probes.device)
        err = library().memex_ivf_probe_list(
            probes.data_ptr(), E, n_clusters, tile_q, n_tiles, scratch.data_ptr(),
            pairs.data_ptr(), tiles.data_ptr(), torch.cuda.current_stream(probes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_probe work list launch failed: cudaError {err}")
    return pairs, tiles


def chunk_ranges(sizes: torch.Tensor, S: int, ranges: int):
    """(g0, g1) [C, ranges]: each cluster's chunks that hold a row,
    ceil(size / S) of them, cut into `ranges` contiguous pieces as the
    kernel cuts them (piece r is [live * r // R, live * (r + 1) // R))."""
    live = (sizes.long() + S - 1) // S
    cut = live[:, None] * torch.arange(ranges + 1, device=sizes.device)[None, :] // ranges
    return cut[:, :-1], cut[:, 1:]


def _probe_scores(data, rscales, sizes, cid, queries):
    """[Q, M] scores of each query against bucket cid[q] (bf16 query against
    bf16-rounded rows, float32 accumulate, times the scale for int8 rows),
    -1e30 past the cluster's size."""
    M = data.shape[1]
    sc = scores_f32(queries[:, None, :], data[cid].transpose(1, 2), exact=False)[:, 0]
    if data.dtype == torch.int8:
        sc = sc * rscales[cid]
    rows_idx = torch.arange(M, device=data.device)[None, :]
    return torch.where(rows_idx < sizes.long()[cid][:, None], sc, NEG_INF)


def ivf_probe_bank_reference(data, rscales, sizes, probes, queries, *, banks: int = 2):
    """Plain version of K7's bank: each query's probed buckets scored in
    probe order (bf16 query against bf16-rounded rows, float32 accumulate,
    times the scale for int8 rows), masked past each cluster's size, folded
    over columns p * M + row, which is the TPU kernel's order."""
    _check_ivf(data, rscales, sizes, queries, banks)
    C, M, D = data.shape
    S = banks * _LANES
    probes = probes.long()
    parts = [_probe_scores(data, rscales, sizes, probes[:, p], queries)
             for p in range(probes.shape[1])]
    bank_v, bank_i = _fold_bank(torch.cat(parts, dim=1), None, S, False)
    v = bank_i[0].long()
    table = torch.gather(probes, 1, v // M) * M + v % M
    return bank_v, [torch.where(bank_v[0] > NEG_INF, table, 0).to(torch.int32)]


def ivf_probe_partials_reference(data, rscales, sizes, probes, queries, ranges: int, *,
                                 banks: int = 2):
    """Plain version of the kernel's partial banks: for query q, rank p and
    range r (chunk_ranges of cluster probes[q, p]), the fold of those chunks
    alone, its winners named by table index cid * M + row (0 where no row
    scored). Returns (vals, idx) [Q, nprobe * ranges, S], rank-major: the
    merge's order."""
    _check_ivf(data, rscales, sizes, queries, banks)
    C, M, D = data.shape
    S = banks * _LANES
    probes = probes.long()
    g0, g1 = chunk_ranges(sizes, S, ranges)
    chunk = (torch.arange(M, device=data.device) // S)[None, :]
    vals, idx = [], []
    for p in range(probes.shape[1]):
        cid = probes[:, p]
        sc = _probe_scores(data, rscales, sizes, cid, queries)
        for r in range(ranges):
            inside = (chunk >= g0[cid, r][:, None]) & (chunk < g1[cid, r][:, None])
            (bv,), (bi,) = _fold_bank(torch.where(inside, sc, NEG_INF), None, S, False)
            vals.append(bv)
            idx.append(torch.where(bv > NEG_INF, cid[:, None] * M + bi.long(), 0).to(torch.int32))
    return torch.stack(vals, 1), torch.stack(idx, 1)


def ivf_probe_merge_reference(part_v: torch.Tensor, part_i: torch.Tensor):
    """Plain version of the kernel's merge: [Q, P, S] partial banks folded
    along P in order with strict '>', from (-1e30, 0). Returns ([vals],
    [idx]) [Q, S]."""
    Q, P, S = part_v.shape
    v = torch.full((Q, S), NEG_INF, dtype=torch.float32, device=part_v.device)
    i = torch.zeros((Q, S), dtype=torch.int32, device=part_v.device)
    for j in range(P):
        take = part_v[:, j] > v
        v = torch.where(take, part_v[:, j], v)
        i = torch.where(take, part_i[:, j], i)
    return [v], [i]


def ivf_probe_bank_cuda(data, rscales, sizes, probes, queries, *, banks: int = 2):
    """Launch K7 (its work list, the scan of the list's items, the merge),
    one call with no host sync; returns the slot bank as ([vals], [idx])."""
    from ..kernels import library

    _check_ivf(data, rscales, sizes, queries, banks)
    queries = queries.contiguous()
    int8 = data.dtype == torch.int8
    if sizes.dtype != torch.int32 or probes.dtype != torch.int32:
        raise TypeError("sizes and probes must be int32")
    if probes.ndim != 2 or probes.shape[0] != queries.shape[0]:
        raise ValueError("probes must be [Q, nprobe]")
    probes = probes.contiguous()
    _need_cuda(data, sizes, probes, queries, *([rscales] if int8 else []))
    lib = library()
    C, M, D = data.shape
    if D % 16 or D > lib.memex_ivf_probe_max_dim():
        raise ValueError(f"row dim {D} unsupported: the IVF kernels take dims that are "
                         f"multiples of 16, <= {lib.memex_ivf_probe_max_dim()}")
    if C * M >= 2**31:
        raise ValueError(f"table of {C} x {M} rows: the fold index must fit in int32")
    S = banks * _LANES
    Q, nprobe = probes.shape
    T, n_tiles, R = probe_plan(Q, nprobe, C, M, S, 4 if data.dtype == torch.float32 else 8)
    if n_tiles * R > _MAX_ITEMS:
        raise ValueError(f"{Q} x {nprobe} probes make up to {n_tiles} tiles: the kernel's "
                         f"grid takes {_MAX_ITEMS} items")
    dev = data.device
    parts = Q * nprobe * R * S
    with torch.cuda.device(dev):
        # Two allocations (each costs host time at Q = 1): the bank and the
        # partial banks' values; the bank's indices, the partial banks'
        # indices and the work list's scratch (its pairs and tiles too).
        floats = torch.empty(Q * S + parts, dtype=torch.float32, device=dev)
        ints = torch.empty(Q * S + parts + 3 * C + Q * nprobe + 3 * n_tiles, dtype=torch.int32,
                           device=dev)
        vals, idx = floats[: Q * S].view(Q, S), ints[: Q * S].view(Q, S)
        err = lib.memex_ivf_probe(
            queries.data_ptr(), data.data_ptr(), ROW_TYPES[data.dtype],
            rscales.data_ptr() if int8 else None, sizes.data_ptr(), probes.data_ptr(), C, T,
            n_tiles, R, ints[Q * S + parts :].data_ptr(), floats[Q * S :].data_ptr(),
            ints[Q * S :].data_ptr(), vals.data_ptr(), idx.data_ptr(), Q, nprobe, D, S, M,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_probe kernel launch failed: cudaError {err}")
    _launched("ivf_probe")
    return [vals], [idx]


def ivf_probe_topk(data, rscales, sizes, probes, queries, k: int, *, banks: int = 2):
    """(data [C, M, D], rscales [C, M], sizes [C], probes [Q, nprobe] in
    probe order, queries [Q, D] f32) -> (vals [Q, k], cluster [Q, k],
    slot [Q, k])."""
    M = data.shape[1]
    bank_fn = ivf_probe_bank_reference if data.device.type == "cpu" else ivf_probe_bank_cuda
    vals, idx = _bank_topk(*bank_fn(data, rscales, sizes.to(torch.int32),
                                    probes.to(torch.int32), queries, banks=banks), k)
    return vals, idx // M, idx % M
