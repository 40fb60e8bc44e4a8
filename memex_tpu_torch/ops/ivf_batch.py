"""Batched IVF probe scan over the union of the batch's probed clusters.

Port of memex_tpu/ops/ivf_batch.py. The batch is routed once
(`route_union`: f32 centroid scores, top-nprobe per query, optional margin
prune, deduplicated into an actives-first cluster list), the active
clusters are flattened into a chunk walk (`_chunk_walk`: walk[t] =
cid * 256 + chunk, ceil(size / S) chunks per active cluster, at least one),
and K5 scores every chunk against the whole query batch, folding row s of
each chunk into slot s of a per-query bank (keep2: the best two per slot).
Every query is scored against the union, a superset of its own probes.

The tensor's device picks the implementation: data on the card launches
the hand-written CUDA kernel (csrc/ivf_batch.cu) or raises; data on the
CPU runs the plain PyTorch version, which folds in the same order.
"""

from __future__ import annotations

import torch

from .fused_topk import (
    _LANES,
    NEG_INF,
    _bank_outputs,
    _bank_topk,
    _fold_bank,
    _launched,
    _need_cuda,
    scores_f32,
)
from .topk import exact_topk

# Row types the IVF kernels take, as their C interface numbers them.
ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# Rows gathered per block by the plain versions (bounds their float32 copy).
_PLAIN_BLOCK = 1 << 18


def route_union(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int,
                prune_margin: float | None = None):
    """Route a query batch and dedupe its probed clusters.

    (centroids [C, D], queries [Q, D]) -> (cluster_list [C] int32, active
    cluster ids ascending, inactive ids after; n_active [1] int32), both on
    the centroids' device. Routing is true float32 (bf16 would misroute
    probes on near-tied centroid scores), top-k ties by lower id. With
    `prune_margin` (cosine units) a probe counts only while its centroid
    score is within the margin of the query's best; None is the keep-all
    sentinel 4.0 (scores span [-1, 1])."""
    C = centroids.shape[0]
    qc = scores_f32(queries, centroids.T, exact=True)
    top_vals, probes = exact_topk(qc, nprobe)
    margin = torch.tensor(4.0 if prune_margin is None else prune_margin,
                          dtype=torch.float32, device=qc.device)
    keep = top_vals >= top_vals[:, :1] - margin
    mask = torch.zeros((C,), dtype=torch.bool, device=qc.device)
    mask[probes[keep].long()] = True
    ids = torch.arange(C, device=qc.device)
    order = torch.argsort(torch.where(mask, ids, C + ids))  # keys are distinct
    return order.to(torch.int32), mask.sum(dtype=torch.int32).reshape(1)


def _chunk_walk(sizes32: torch.Tensor, cluster_list: torch.Tensor, n_active: torch.Tensor,
                M: int, S: int):
    """Flattened (cluster, chunk) walk, computed on the device: (walk
    [C * (M // S)] int32 packed cid * 256 + chunk, n_chunks [1] int32).
    Entries past n_chunks are clamped garbage the kernel never reads. An
    empty active cluster still costs one masked chunk. The chunk index is
    packed into 8 bits, so M / S must be <= 256."""
    if M // S > 256:
        raise ValueError(f"bucket M={M} has {M // S} chunks of {S}; the packed walk "
                         "carries at most 256 -- raise n_clusters or chunk width")
    C = sizes32.shape[0]
    dev = sizes32.device
    T = C * (M // S)
    chunks_per = torch.clamp((sizes32 + S - 1) // S, min=1)
    chunks_act = torch.where(torch.arange(C, device=dev) < n_active[0],
                             chunks_per[cluster_list.long()], 0)
    cum = torch.cumsum(chunks_act, 0, dtype=torch.int64)
    t_iota = torch.arange(T, device=dev, dtype=torch.int64)
    p = torch.clamp(torch.searchsorted(cum, t_iota, right=True), max=C - 1)
    start = cum - chunks_act
    cid = cluster_list.long()[p]
    j = t_iota - start[p]
    walk = (cid * 256 + torch.clamp(j, 0, 255)).to(torch.int32)
    return walk, cum[-1:].to(torch.int32)


def _check_ivf(data: torch.Tensor, rscales: torch.Tensor, sizes: torch.Tensor,
               queries: torch.Tensor, banks: int) -> None:
    if data.ndim != 3 or data.dtype not in ROW_TYPES:
        raise TypeError(f"data must be a [C, M, D] float32, bfloat16 or int8 tensor, got "
                        f"{tuple(data.shape)} {data.dtype}")
    C, M, D = data.shape
    if rscales.shape != (C, M) or rscales.dtype != torch.float32:
        raise ValueError("rscales must be a float32 [C, M] tensor")
    if sizes.shape != (C,):
        raise ValueError("sizes must be a [C] tensor")
    if queries.ndim != 2 or queries.dtype != torch.float32 or queries.shape[1] != D:
        raise TypeError(f"queries must be float32 [Q, {D}], got {tuple(queries.shape)} "
                        f"{queries.dtype}")
    if banks < 1 or M % (banks * _LANES):
        raise ValueError(f"cluster bucket M={M} must be a multiple of {banks * _LANES}")


def _union_columns(walk: torch.Tensor, n_chunks: torch.Tensor, sizes: torch.Tensor,
                   M: int, S: int):
    """The union as a virtual row space: column t * S + s is row
    (walk[t] & 255) * S + s of cluster walk[t] >> 8. Returns (col
    [n_chunks * S] int64, that row's index cid * M + row in the [C * M]
    table; live [n_chunks * S] bool, row < the cluster's size). Reads
    n_chunks on the host: plain versions only."""
    w = walk[: int(n_chunks[0])].long()
    row = (w & 255)[:, None] * S + torch.arange(S, device=w.device)[None, :]
    live = row < sizes.long()[w >> 8][:, None]
    return ((w >> 8)[:, None] * M + row).reshape(-1), live.reshape(-1)


def _fold_table(scores: torch.Tensor, col: torch.Tensor, S: int, keep2: bool):
    """_fold_bank over the virtual columns, its winners renamed to their
    table index. A slot that never took a row keeps index 0, as the
    kernels' banks start."""
    Q = scores.shape[0]
    if not col.numel():
        bank_v = [torch.full((Q, S), NEG_INF, dtype=torch.float32, device=scores.device)]
        bank_i = [torch.zeros((Q, S), dtype=torch.int32, device=scores.device)]
        n = 2 if keep2 else 1
        return bank_v * n, bank_i * n
    bank_v, bank_i = _fold_bank(scores, None, S, keep2)
    return bank_v, [torch.where(v > NEG_INF, col[i.long()], 0).to(torch.int32)
                    for v, i in zip(bank_v, bank_i)]


def ivf_batch_bank_reference(data, rscales, sizes, walk, n_chunks, queries, *,
                             banks: int = 4, exact: bool = False, keep2: bool = False):
    """Plain version of K5's bank: the walk's rows gathered into the
    virtual [n_chunks * S, D] matrix, scored in float32 (bf16-rounded
    inputs unless `exact` on float32 rows), times the row scale for int8
    rows, masked past each cluster's size, then the fold. Returns
    ([vals], [idx]) lists of [Q, S] tensors (two of each with keep2)."""
    _check_ivf(data, rscales, sizes, queries, banks)
    C, M, D = data.shape
    S = banks * _LANES
    col, live = _union_columns(walk, n_chunks, sizes, M, S)
    exact = exact and data.dtype == torch.float32
    flat, flat_sc = data.reshape(C * M, D), rscales.reshape(C * M)
    parts = []
    for lo in range(0, col.numel(), _PLAIN_BLOCK):
        c = col[lo : lo + _PLAIN_BLOCK]
        sc = scores_f32(queries, flat[c].T, exact)
        if data.dtype == torch.int8:
            sc = sc * flat_sc[c][None, :]
        parts.append(sc)
    scores = torch.cat(parts, dim=1) if parts else queries.new_zeros((queries.shape[0], 0))
    scores = torch.where(live[None, :], scores, NEG_INF)
    return _fold_table(scores, col, S, keep2)


def ivf_batch_bank_cuda(data, rscales, sizes, walk, n_chunks, queries, *,
                        banks: int = 4, exact: bool = False, keep2: bool = False):
    """Launch K5; returns the slot bank as ([vals], [idx]). The walk and
    n_chunks stay on the card. Raises on anything the kernel does not
    take, and on a refused launch."""
    from ..kernels import library

    _check_ivf(data, rscales, sizes, queries, banks)
    queries = queries.contiguous()
    int8 = data.dtype == torch.int8
    if sizes.dtype != torch.int32 or walk.dtype != torch.int32 or n_chunks.dtype != torch.int32:
        raise TypeError("sizes, walk and n_chunks must be int32")
    _need_cuda(data, sizes, walk, n_chunks, queries, *([rscales] if int8 else []))
    lib = library()
    C, M, D = data.shape
    if D % 16 or D > lib.memex_ivf_batch_max_dim():
        raise ValueError(f"row dim {D} unsupported: the IVF kernels take dims that are "
                         f"multiples of 16, <= {lib.memex_ivf_batch_max_dim()}")
    if C * M >= 2**31:
        raise ValueError(f"table of {C} x {M} rows: the fold index must fit in int32")
    S = banks * _LANES
    Q = queries.shape[0]
    exact = exact and data.dtype == torch.float32
    with torch.cuda.device(data.device):
        vals, idx = _bank_outputs(data, Q, S, keep2)
        err = lib.memex_ivf_batch(
            queries.data_ptr(), data.data_ptr(), ROW_TYPES[data.dtype],
            rscales.data_ptr() if int8 else None, sizes.data_ptr(), walk.data_ptr(),
            n_chunks.data_ptr(), vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None, idx[-1].data_ptr() if keep2 else None,
            Q, D, S, M, int(exact), int(keep2),
            torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_batch kernel launch failed: cudaError {err}")
    _launched("ivf_batch")
    return vals, idx


def ivf_batch_topk(data, rscales, sizes, cluster_list, n_active, queries, k: int, *,
                   banks: int = 4, exact: bool = False, keep2: bool = False):
    """(data [C, M, D] float32/bfloat16/int8, rscales [C, M] f32, sizes [C],
    cluster_list [C] actives first, n_active [1], queries [Q, D] f32) ->
    (vals [Q, k], cluster [Q, k], slot [Q, k]). S = banks * 128 chunk rows
    (M must be a multiple); `exact` (float32 rows) scores in true float32;
    keep2 widens the bank to the best two rows per slot."""
    M = data.shape[1]
    S = banks * _LANES
    walk, n_chunks = _chunk_walk(sizes.to(torch.int32), cluster_list, n_active, M, S)
    bank_fn = ivf_batch_bank_reference if data.device.type == "cpu" else ivf_batch_bank_cuda
    bank = bank_fn(data, rscales, sizes.to(torch.int32), walk, n_chunks, queries,
                   banks=banks, exact=exact, keep2=keep2)
    vals, idx = _bank_topk(*bank, k)
    return vals, idx // M, idx % M


def ivf_batch_search(centroids, data, rscales, sizes, queries, nprobe: int, k: int,
                     banks: int = 4, prune_margin: float | None = None,
                     exact: bool = False, keep2: bool = False):
    """Routing + dedupe + the batch-union scan (K5)."""
    clist, nact = route_union(centroids, queries, nprobe, prune_margin=prune_margin)
    return ivf_batch_topk(data, rscales, sizes, clist, nact, queries, k, banks=banks,
                          exact=exact, keep2=keep2)
