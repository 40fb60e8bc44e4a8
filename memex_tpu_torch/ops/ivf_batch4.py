"""int4 scan tier of the batch-union IVF scan (port of
memex_tpu/ops/ivf_batch4.py).

The index stays authoritative in int8; a row-pair packed int4 mirror,
[C, M/2, D] int8, is scanned instead (half the bytes) and the candidate
bank is reranked against the int8 table. Byte (c, j * S/2 + off, d) is
16 * hi + lo, hi the int4 code (round(int8 / 16) via (x + 8) >> 4, clipped
to [-7, 7]) of bucket row j * S + off and lo that of row j * S + S/2 + off:
each S-row chunk folded in half onto itself. K6 scores both halves from
one read: se = q . hi, so = q . b - 16 * se.

The tensor's device picks the implementation: data on the card launches
the hand-written CUDA kernel (csrc/ivf_batch4.cu) or raises; data on the
CPU runs the plain PyTorch version.
"""

from __future__ import annotations

import torch

from .fused_topk import _LANES, NEG_INF, _bank_outputs, _bank_topk, _launched, _need_cuda
from .fused_topk import scores_f32
from .ivf_batch import _PLAIN_BLOCK, _chunk_walk, _fold_table, _union_columns, route_union
from .topk import exact_topk


def pack_int4_buckets(data_i8: torch.Tensor, rscales: torch.Tensor, c_blk: int = 64,
                      banks: int = 4):
    """int8 bucket table -> (data4 [C, M/2, D] int8 row-pair packed,
    rscales4 [C, M] f32 = rscales * 16). The mirror is written in place,
    c_blk clusters at a time, into one preallocated tensor: the extra
    memory is the mirror plus c_blk * M * D int32 intermediates."""
    C, M, D = data_i8.shape
    S = banks * _LANES
    S2 = S // 2
    if M % S:
        raise ValueError(f"bucket M={M} must be a multiple of chunk {S}")
    out4 = torch.empty((C, M // 2, D), dtype=torch.int8, device=data_i8.device)
    for c0 in range(0, C, c_blk):
        blk = data_i8[c0 : c0 + c_blk].to(torch.int32)
        q4 = torch.clamp((blk + 8) >> 4, -7, 7).reshape(-1, M // S, S, D)
        out4[c0 : c0 + c_blk] = (16 * q4[:, :, :S2] + q4[:, :, S2:]).to(torch.int8).reshape(
            -1, M // 2, D)
    return out4, rscales * 16.0


def _check4(data4, rscales4, sizes, queries, banks: int) -> None:
    if data4.ndim != 3 or data4.dtype != torch.int8:
        raise TypeError(f"data4 must be a [C, M/2, D] int8 tensor, got {tuple(data4.shape)} "
                        f"{data4.dtype}")
    C, M2, D = data4.shape
    if rscales4.shape != (C, 2 * M2) or rscales4.dtype != torch.float32:
        raise ValueError("rscales4 must be a float32 [C, M] tensor")
    if sizes.shape != (C,):
        raise ValueError("sizes must be a [C] tensor")
    if queries.ndim != 2 or queries.dtype != torch.float32 or queries.shape[1] != D:
        raise TypeError(f"queries must be float32 [Q, {D}]")
    if banks < 1 or (2 * M2) % (banks * _LANES):
        raise ValueError(f"cluster bucket M={2 * M2} must be a multiple of {banks * _LANES}")


def ivf_batch4_bank_reference(data4, rscales4, sizes, walk, n_chunks, queries, *,
                              banks: int = 4, keep2: bool = False):
    """Plain version of K6's bank: each chunk's S/2 packed rows gathered,
    se = bf16(q) . hi and sraw = bf16(q) . b in float32 (exact integer
    operands), the chunk's scores [se, sraw - 16 se] times rscales4, masked
    past each cluster's size, then the fold."""
    _check4(data4, rscales4, sizes, queries, banks)
    C, M2, D = data4.shape
    M, S = 2 * M2, banks * _LANES
    S2 = S // 2
    col, live = _union_columns(walk, n_chunks, sizes, M, S)
    # The packed rows of chunk t: cid * M/2 + j * S/2 + s for s < S/2.
    w = walk[: int(n_chunks[0])].long()
    prow = (((w >> 8) * M2 + (w & 255) * S2)[:, None]
            + torch.arange(S2, device=w.device)[None, :]).reshape(-1)
    flat, flat_sc = data4.reshape(C * M2, D), rscales4.reshape(C * M)
    parts = []
    step = _PLAIN_BLOCK // S2 * S2
    for lo in range(0, prow.numel(), step):
        b = flat[prow[lo : lo + step]].to(torch.int32)
        hi = (b + 8) >> 4
        se = scores_f32(queries, hi.T.float(), exact=False)
        sraw = scores_f32(queries, b.T.float(), exact=False)
        so = sraw - 16.0 * se
        q_n = queries.shape[0]
        parts.append(torch.cat([se.reshape(q_n, -1, S2), so.reshape(q_n, -1, S2)],
                               dim=2).reshape(q_n, -1))
    scores = torch.cat(parts, dim=1) if parts else queries.new_zeros((queries.shape[0], 0))
    scores = torch.where(live[None, :], scores * flat_sc[col][None, :], NEG_INF)
    return _fold_table(scores, col, S, keep2)


def ivf_batch4_bank_cuda(data4, rscales4, sizes, walk, n_chunks, queries, *,
                         banks: int = 4, keep2: bool = False):
    """Launch K6; returns the slot bank as ([vals], [idx])."""
    from ..kernels import library

    _check4(data4, rscales4, sizes, queries, banks)
    queries = queries.contiguous()
    if sizes.dtype != torch.int32 or walk.dtype != torch.int32 or n_chunks.dtype != torch.int32:
        raise TypeError("sizes, walk and n_chunks must be int32")
    _need_cuda(data4, rscales4, sizes, walk, n_chunks, queries)
    lib = library()
    C, M2, D = data4.shape
    if D % 16 or D > lib.memex_ivf_batch4_max_dim():
        raise ValueError(f"row dim {D} unsupported: the IVF kernels take dims that are "
                         f"multiples of 16, <= {lib.memex_ivf_batch4_max_dim()}")
    if C * 2 * M2 >= 2**31:
        raise ValueError(f"table of {C} x {2 * M2} rows: the fold index must fit in int32")
    S = banks * _LANES
    Q = queries.shape[0]
    with torch.cuda.device(data4.device):
        vals, idx = _bank_outputs(data4, Q, S, keep2)
        err = lib.memex_ivf_batch4(
            queries.data_ptr(), data4.data_ptr(), rscales4.data_ptr(), sizes.data_ptr(),
            walk.data_ptr(), n_chunks.data_ptr(), vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None, idx[-1].data_ptr() if keep2 else None,
            Q, D, S, 2 * M2, int(keep2), torch.cuda.current_stream(data4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_batch4 kernel launch failed: cudaError {err}")
    _launched("ivf_batch4")
    return vals, idx


def ivf_batch_topk4(data4, rscales4, sizes, cluster_list, n_active, queries, k: int, *,
                    banks: int = 4, keep2: bool = False):
    """(data4 [C, M/2, D] packed, rscales4 [C, M] f32 (int8 scale x 16),
    sizes [C], cluster_list [C] actives first, n_active [1], queries [Q, D]
    f32) -> (vals [Q, k], cluster [Q, k], slot [Q, k])."""
    M = 2 * data4.shape[1]
    S = banks * _LANES
    walk, n_chunks = _chunk_walk(sizes.to(torch.int32), cluster_list, n_active, M, S)
    bank_fn = ivf_batch4_bank_reference if data4.device.type == "cpu" else ivf_batch4_bank_cuda
    bank = bank_fn(data4, rscales4, sizes.to(torch.int32), walk, n_chunks, queries,
                   banks=banks, keep2=keep2)
    vals, idx = _bank_topk(*bank, k)
    return vals, idx // M, idx % M


def rerank_int8(data, rscales, queries, vals4, cl, sl, k: int):
    """Re-score int4-scan candidates against the authoritative int8 table
    (bf16 inputs, float32 accumulate, times the int8 scale) and take the
    top-k, ties by lower position. (data [C, M, D] int8, rscales [C, M],
    queries [Q, D] f32, vals4/cl/sl [Q, r]) -> (vals, cluster, slot) [Q, k].
    Candidates the int4 pass masked out stay masked."""
    C, M, D = data.shape
    flat = cl.long() * M + sl.long()
    rows = data.reshape(C * M, D)[flat]  # [Q, r, D]
    sc = scores_f32(queries[:, None, :], rows.transpose(1, 2), exact=False)[:, 0]
    sc = sc * rscales.reshape(-1)[flat]
    sc = torch.where(vals4 <= NEG_INF / 2, NEG_INF, sc)
    vals, args = exact_topk(sc, k)
    args = args.long()
    return vals, torch.gather(cl, 1, args), torch.gather(sl, 1, args)


def ivf_batch_search4(centroids, data4, rscales4, data, rscales, sizes, queries,
                      nprobe: int, k: int, rerank: int | None = None, banks: int = 4,
                      prune_margin: float | None = None, keep2: bool = False):
    """Routing + dedupe + the int4 batch-union scan (K6) + the int8 rerank.
    By default the whole candidate bank (S = banks * 128, 2S with keep2) is
    re-scored; `rerank` narrows it to min(max(rerank * k, 64), S)."""
    S = (2 if keep2 else 1) * banks * _LANES
    clist, nact = route_union(centroids, queries, nprobe, prune_margin=prune_margin)
    r = S if rerank is None else min(max(rerank * k, 64), S)
    v4, cl, sl = ivf_batch_topk4(data4, rscales4, sizes, clist, nact, queries, r,
                                 banks=banks, keep2=keep2)
    return rerank_int8(data, rscales, queries, v4, cl, sl, k)
