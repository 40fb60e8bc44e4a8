"""Per-query IVF probe scan (port of memex_tpu/ops/ivf_scan.py).

Strict per-query IVF: query q scores the whole buckets of its own
`nprobe` clusters, in probe order, and folds bucket row g * S + s of
each into slot s of its bank (single winner, S = banks * 128, 256 by
default). It serves the IVF index where the batch-union scan (K5) cannot
take the bucket (IVFIndex.search's eligibility rule).

The tensor's device picks the implementation: data on the card launches
the hand-written CUDA kernel K7 (csrc/ivf_scan.cu) or raises; data on the
CPU runs the plain PyTorch version, which folds in the same order.
"""

from __future__ import annotations

import torch

from .fused_topk import _LANES, NEG_INF, _bank_outputs, _bank_topk, _fold_bank, _launched
from .fused_topk import _need_cuda, scores_f32
from .ivf_batch import ROW_TYPES, _check_ivf


def ivf_probe_bank_reference(data, rscales, sizes, probes, queries, *, banks: int = 2):
    """Plain version of K7's bank: each query's probed buckets scored in
    probe order (bf16 query against bf16-rounded rows, float32 accumulate,
    times the scale for int8 rows), masked past each cluster's size, folded
    over columns p * M + row, which is the kernel's order."""
    _check_ivf(data, rscales, sizes, queries, banks)
    C, M, D = data.shape
    S = banks * _LANES
    probes = probes.long()
    rows_idx = torch.arange(M, device=data.device)[None, :]
    parts = []
    for p in range(probes.shape[1]):
        cid = probes[:, p]
        sc = scores_f32(queries[:, None, :], data[cid].transpose(1, 2), exact=False)[:, 0]
        if data.dtype == torch.int8:
            sc = sc * rscales[cid]
        parts.append(torch.where(rows_idx < sizes.long()[cid][:, None], sc, NEG_INF))
    bank_v, bank_i = _fold_bank(torch.cat(parts, dim=1), None, S, False)
    v = bank_i[0].long()
    table = torch.gather(probes, 1, v // M) * M + v % M
    return bank_v, [torch.where(bank_v[0] > NEG_INF, table, 0).to(torch.int32)]


def ivf_probe_bank_cuda(data, rscales, sizes, probes, queries, *, banks: int = 2):
    """Launch K7; returns the slot bank as ([vals], [idx])."""
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
    with torch.cuda.device(data.device):
        vals, idx = _bank_outputs(data, Q, S, False)
        err = lib.memex_ivf_probe(
            queries.data_ptr(), data.data_ptr(), ROW_TYPES[data.dtype],
            rscales.data_ptr() if int8 else None, sizes.data_ptr(), probes.data_ptr(),
            vals[0].data_ptr(), idx[0].data_ptr(), Q, nprobe, D, S, M,
            torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ivf_probe kernel launch failed: cudaError {err}")
    _launched("ivf_probe")
    return vals, idx


def ivf_probe_topk(data, rscales, sizes, probes, queries, k: int, *, banks: int = 2):
    """(data [C, M, D], rscales [C, M], sizes [C], probes [Q, nprobe] in
    probe order, queries [Q, D] f32) -> (vals [Q, k], cluster [Q, k],
    slot [Q, k])."""
    M = data.shape[1]
    bank_fn = ivf_probe_bank_reference if data.device.type == "cpu" else ivf_probe_bank_cuda
    vals, idx = _bank_topk(*bank_fn(data, rscales, sizes.to(torch.int32),
                                    probes.to(torch.int32), queries, banks=banks), k)
    return vals, idx // M, idx % M
