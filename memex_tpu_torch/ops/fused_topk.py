"""Fused brute-force MIPS top-k: the flat index's scans.

Port of memex_tpu/ops/fused_topk.py. Four kernels, one family: for Q
queries against N rows each scores the rows, masks columns >= `count`
and dead rows to -1e30, and folds column c into slot c mod S (S = banks *
128) of a per-query bank, keeping each slot's best value (keep2: its best
two, in the exact single-insertion order of the TPU fold). The wrapper
then sorts the [Q, S] (keep2: [Q, 2S]) bank stably to the top-k, as the
JAX wrappers do outside their kernels.

  K1 `fused_score_topk`        float32/bfloat16 rows (`_fused_kernel`)
  K2 `fused_score_topk_int8q`  int8 rows, int8 queries (`_fused_kernel_int8q`),
                               also the coarse stage of
                               `fused_score_topk_int8q_rerank`
  K3 `fused_score_topk_int8`   int8 rows, bf16 queries (`_fused_kernel_int8`)
  K4 `int4q_candidates`        packed int4 rows (`_fused_kernel_int4q`), the
                               coarse stage of `fused_score_topk_int4_rerank`

The tensor's device picks the implementation: rows on the card launch the
hand-written CUDA kernel (csrc/fused_topk*.cu) or raise; rows on the CPU
run the plain PyTorch version, which folds in the same order. A CUDA
tensor never falls back to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..metrics import METRICS

from .topk import exact_topk, scores_f32

NEG_INF = -1e30
_LANES = 128
# The int4 row scale is the int8 one times 127/7 (same per-row absmax, 7
# vs 127 levels), a float32 multiply as in memex_tpu.
INT4_SCALE = float(np.float32(127.0 / 7.0))

# Kernel launches made in this process, by kernel (the IVF scans of
# ops/ivf_*.py count here too). Callers reset and read them to prove a path
# went through a CUDA kernel; only a launch counts.
LAUNCHES = dict.fromkeys(("fused_topk", "fused_topk_int8q", "fused_topk_int8",
                          "fused_topk_int4q", "ivf_batch", "ivf_batch4", "ivf_probe"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(name: str) -> None:
    LAUNCHES[name] += 1
    METRICS.inc(f"kernels.{name}.launches")


def _check_rows(db: torch.Tensor, alive, banks: int) -> None:
    if alive is not None and (alive.shape != (db.shape[0],)
                              or alive.dtype != torch.float32
                              or alive.device != db.device):
        raise ValueError("alive must be a float32 [N] tensor on the rows' device")
    if banks < 1:
        raise ValueError(f"banks must be >= 1, got {banks}")


def _check_queries(queries: torch.Tensor, dim: int, device) -> None:
    if queries.ndim != 2 or queries.dtype != torch.float32:
        raise TypeError(f"queries must be a 2-D float32 tensor, got "
                        f"{tuple(queries.shape)} {queries.dtype}")
    if queries.shape[1] != dim:
        raise ValueError(f"query dim {queries.shape[1]} != row dim {dim}")
    if queries.device != device:
        raise ValueError(f"queries on {queries.device}, rows on {device}")


def _check(db: torch.Tensor, queries: torch.Tensor, alive, banks: int) -> None:
    if db.ndim != 2 or db.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"db must be a 2-D float32 or bfloat16 tensor, got "
                        f"{tuple(db.shape)} {db.dtype}")
    _check_queries(queries, db.shape[1], db.device)
    _check_rows(db, alive, banks)


def _check_quant(codes: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                 alive, banks: int, dim: int) -> None:
    """codes: int8 [N, dim] (int4: packed [N, dim/2]); scales float32 [N]."""
    if codes.ndim != 2 or codes.dtype != torch.int8:
        raise TypeError(f"codes must be a 2-D int8 tensor, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    if (scales.shape != (codes.shape[0],) or scales.dtype != torch.float32
            or scales.device != codes.device):
        raise ValueError("scales must be a float32 [N] tensor on the codes' device")
    _check_queries(queries, dim, codes.device)
    _check_rows(codes, alive, banks)


def _limit(n: int, count) -> int:
    return n if count is None else max(0, min(int(count), n))


def _fold_bank(scores: torch.Tensor, alive, S: int, keep2: bool):
    """The plain fold: scores [Q, limit] of the columns below `count`;
    dead columns are masked, then column c folds into slot c mod S in
    ascending order (_fold_chunks). Returns the bank as ([vals], [idx])
    lists of [Q, S] tensors (two of each with keep2)."""
    Q, limit = scores.shape
    if alive is not None:
        scores = torch.where(alive[None, :limit] > 0, scores,
                             torch.full_like(scores, NEG_INF))
    # Columns past `limit` never change a slot (-1e30 never beats the
    # -1e30 init), so the fold stops at the fill level.
    G = -(-limit // S)
    if G * S != limit:
        scores = torch.nn.functional.pad(scores, (0, G * S - limit), value=NEG_INF)
    acc_v = torch.full((Q, S), NEG_INF, dtype=torch.float32, device=scores.device)
    acc_i = torch.zeros((Q, S), dtype=torch.int32, device=scores.device)
    acc_v2, acc_i2 = acc_v.clone(), acc_i.clone()
    slot = torch.arange(S, dtype=torch.int32, device=scores.device)[None, :]
    for g in range(G):
        chunk = scores[:, g * S : (g + 1) * S]
        cidx = (g * S + slot).expand(Q, S)
        take = chunk > acc_v
        if keep2:
            dem_v = torch.where(take, acc_v, chunk)  # loser of the top duel
            dem_i = torch.where(take, acc_i, cidx)
            take2 = dem_v > acc_v2
            acc_v2 = torch.where(take2, dem_v, acc_v2)
            acc_i2 = torch.where(take2, dem_i, acc_i2)
        acc_v = torch.where(take, chunk, acc_v)
        acc_i = torch.where(take, cidx, acc_i)
    if keep2:
        return [acc_v, acc_v2], [acc_i, acc_i2]
    return [acc_v], [acc_i]


def _bank_topk(bank_v: list[torch.Tensor], bank_i: list[torch.Tensor], k: int):
    """Exact top-k over the candidate bank: a stable descending order, so
    equal values keep bank order (jnp.argsort(-vals) in the JAX wrapper)."""
    vals = torch.cat(bank_v, dim=1)
    idx = torch.cat(bank_i, dim=1)
    order = torch.sort(-vals, dim=1, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def _bank_outputs(db: torch.Tensor, q_n: int, S: int, keep2: bool):
    n = 2 if keep2 else 1
    vals = [torch.empty((q_n, S), dtype=torch.float32, device=db.device) for _ in range(n)]
    idx = [torch.empty((q_n, S), dtype=torch.int32, device=db.device) for _ in range(n)]
    return vals, idx


def _need_cuda(*tensors: torch.Tensor) -> None:
    """The kernels read raw pointers: tensors on the card, contiguous, at
    16-byte aligned addresses (the widest load they issue)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the CUDA kernel needs tensors on the card, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


# -- K1: float32 / bfloat16 rows -------------------------------------------------


def fused_score_topk_reference(db: torch.Tensor, queries: torch.Tensor, k: int,
                               count=None, alive=None, *, banks: int = 8,
                               exact: bool = False, keep2: bool = False):
    """Plain PyTorch version of the kernel: same inputs, same fold order,
    same (vals [Q, k], idx [Q, k]), scored by `scores_f32`."""
    _check(db, queries, alive, banks)
    limit = _limit(db.shape[0], count)
    exact = exact and db.dtype == torch.float32
    scores = scores_f32(queries, db[:limit].T, exact)
    return _bank_topk(*_fold_bank(scores, alive, banks * _LANES, keep2), k)


def fused_score_bank_cuda(db: torch.Tensor, queries: torch.Tensor, count=None,
                          alive=None, *, banks: int = 8, exact: bool = False,
                          keep2: bool = False):
    """Launch the CUDA kernel; returns the slot bank as ([vals], [idx])
    lists of [Q, S] tensors (two of each with keep2). Raises on anything
    the kernel does not take, and on a refused launch."""
    from ..kernels import library

    _check(db, queries, alive, banks)
    queries = queries.contiguous()
    _need_cuda(db, queries, *([alive] if alive is not None else []))
    lib = library()
    n, d = db.shape
    if d % 16 or d > lib.memex_fused_topk_max_dim():
        raise ValueError(f"row dim {d} unsupported: the kernel takes dims that are "
                         f"multiples of 16, <= {lib.memex_fused_topk_max_dim()}")
    S = banks * _LANES
    Q = queries.shape[0]
    exact = exact and db.dtype == torch.float32
    with torch.cuda.device(db.device):
        vals, idx = _bank_outputs(db, Q, S, keep2)
        err = lib.memex_fused_topk(
            queries.data_ptr(), db.data_ptr(), int(db.dtype == torch.bfloat16),
            alive.data_ptr() if alive is not None else None,
            vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None,
            idx[-1].data_ptr() if keep2 else None,
            Q, d, S, _limit(n, count), int(exact), int(keep2),
            torch.cuda.current_stream(db.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: cudaError {err}")
    _launched("fused_topk")
    return vals, idx


def fused_score_topk(db: torch.Tensor, queries: torch.Tensor, k: int,
                     count=None, alive=None, *, banks: int = 8,
                     exact: bool = False, keep2: bool = False):
    """([N, D] rows, [Q, D] queries) -> (vals [Q, k], idx [Q, k]).

    `alive` ([N] float32, optional) masks tombstoned rows inside the scan
    so they never claim a candidate slot. `exact` (float32 rows only)
    scores in true float32; otherwise both inputs are rounded to bf16.
    `keep2` keeps the best two rows per slot."""
    if db.device.type == "cpu":
        return fused_score_topk_reference(db, queries, k, count, alive,
                                          banks=banks, exact=exact, keep2=keep2)
    vals, idx = fused_score_bank_cuda(db, queries, count, alive, banks=banks,
                                      exact=exact, keep2=keep2)
    return _bank_topk(vals, idx, k)


# -- quantizers ----------------------------------------------------------------


# XLA rewrites a division by a constant into a multiply by its float32
# reciprocal, so memex_tpu's jitted quantizers (and the int8 kernels' query
# quantization) compute `absmax / 127.0` as `absmax * f32(1 / 127)`.
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float -> ([N, D] int8, [N] float32 scales). Symmetric per row:
    scale = max(|row|, 1e-12) / 127, code = round-half-even(x / scale)
    clipped to [-127, 127], in the float32 arithmetic of memex_tpu's jitted
    `quantize_rows_int8` and of its int8 kernels' query quantization."""
    x = x.float()
    scales = torch.clamp(x.abs().amax(dim=1), min=1e-12) * _INV127
    codes = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def quantize_rows_int8_refine(x: torch.Tensor):
    """Coarse int8 codes plus int8 codes of the quantization residual, each
    per-row scaled (memex_tpu's jitted `quantize_rows_int8_refine`, whose
    residual x - code * scale is one fused multiply-add: one rounding, as
    the float64 difference here). [N, D] -> (int8 [N, D], f32 [N],
    int8 [N, D], f32 [N])."""
    x = x.float()
    codes, scales = quantize_rows_int8(x)
    resid = (x.double() - codes.double() * scales.double()[:, None]).float()
    rscales = torch.clamp(resid.abs().amax(dim=1), min=1e-14) * _INV127
    rcodes = torch.clamp(torch.round(resid / rscales[:, None]), -127, 127).to(torch.int8)
    return codes, scales, rcodes, rscales


# `absmax / 7.0` as memex_tpu's jitted int4 quantizer computes it (see _INV127).
_INV7 = float(np.float32(1.0 / 7.0))


def quantize_rows_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device int4 pack: [N, D] float -> ([N, D/2] int8 packed rows, [N]
    float32 scales), on x's device. Symmetric per row: scale = max(|row|,
    1e-12) / 7, code = round-half-even(x / scale) clipped to [-7, 7], and
    byte j holds the signed value code[j] + 16 * code[j + D/2], in the
    float32 arithmetic of memex_tpu's jitted `quantize_rows_int4`. memex_tpu
    returns the packed array transposed ([D/2, N], its TPU layout); the
    port keeps rows contiguous, as `np_quantize_rows_int4` does."""
    x = x.float()
    d = x.shape[1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    scales = torch.clamp(x.abs().amax(dim=1), min=1e-12) * _INV7
    codes = torch.clamp(torch.round(x / scales[:, None]), -7, 7).to(torch.int32)
    packed = codes[:, : d // 2] + 16 * codes[:, d // 2 :]  # |b| <= 119
    return packed.to(torch.int8).contiguous(), scales


def np_quantize_rows_int4(vectors) -> tuple[np.ndarray, np.ndarray]:
    """Host-side int4 pack (ingest path): [M, D] f32 -> ([M, D/2] int8
    packed rows, [M] f32 scales). Symmetric per row to [-7, 7]; byte j
    holds the signed value 16 * code[j + D/2] + code[j]. memex_tpu returns
    the transpose of the packed array (its TPU layout); the port keeps
    rows contiguous, which is what a warp reads on the card."""
    v = np.asarray(vectors, np.float32)
    d = v.shape[1]
    absmax = np.abs(v).max(axis=1)
    scales = np.maximum(absmax, 1e-12) / 7.0
    codes = np.clip(np.round(v / scales[:, None]), -7, 7).astype(np.int32)
    lo, hi = codes[:, : d // 2], codes[:, d // 2 :]
    return np.ascontiguousarray((lo + 16 * hi).astype(np.int8)), scales.astype(np.float32)


def pack_int4_from_int8(codes: np.ndarray) -> np.ndarray:
    """Packed int4 rows [M, D/2] re-derived from int8 codes [M, D] (the
    checkpoint restore path: checkpoints hold int8 codes only). A code can
    land one level off the direct float quantization; the int8 rerank that
    follows the int4 scan is unaffected."""
    d = codes.shape[1]
    c4 = np.clip(np.round(codes.astype(np.float32) * (7.0 / 127.0)), -7, 7).astype(np.int32)
    return np.ascontiguousarray((c4[:, : d // 2] + 16 * c4[:, d // 2 :]).astype(np.int8))


# -- K2: int8 rows, int8 queries -----------------------------------------------


def int8q_bank_reference(db_q: torch.Tensor, scales: torch.Tensor, q8: torch.Tensor,
                         count=None, alive=None, *, banks: int = 8, keep2: bool = False):
    """Plain version of K2's bank: the s8 x s8 dot as a float32 matmul of
    integer values (exact: |raw| <= D * 127^2 < 2^24 for D <= 1040), one
    rounding of `raw * scale`, then the fold."""
    limit = _limit(db_q.shape[0], count)
    raw = scores_f32(q8.float(), db_q[:limit].T.float(), exact=True)
    return _fold_bank(raw * scales[None, :limit], alive, banks * _LANES, keep2)


def fused_score_bank_int8q_cuda(db_q: torch.Tensor, scales: torch.Tensor, q8: torch.Tensor,
                                count=None, alive=None, *, banks: int = 8,
                                keep2: bool = False):
    """Launch K2 on int8 queries `q8`; returns the slot bank as
    ([vals], [idx]). Raises on anything the kernel does not take."""
    from ..kernels import library

    if q8.dtype != torch.int8 or q8.ndim != 2 or q8.shape[1] != db_q.shape[1]:
        raise TypeError("q8 must be int8 [Q, D] queries")
    q8 = q8.contiguous()
    _need_cuda(db_q, scales, q8, *([alive] if alive is not None else []))
    lib = library()
    n, d = db_q.shape
    if d % 16 or d > lib.memex_fused_topk_int8_max_dim():
        raise ValueError(f"row dim {d} unsupported: the int8 kernels take dims that are "
                         f"multiples of 16, <= {lib.memex_fused_topk_int8_max_dim()}")
    S = banks * _LANES
    Q = q8.shape[0]
    with torch.cuda.device(db_q.device):
        vals, idx = _bank_outputs(db_q, Q, S, keep2)
        err = lib.memex_fused_topk_int8q(
            q8.data_ptr(), db_q.data_ptr(), scales.data_ptr(),
            alive.data_ptr() if alive is not None else None,
            vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None,
            idx[-1].data_ptr() if keep2 else None,
            Q, d, S, _limit(n, count), int(keep2),
            torch.cuda.current_stream(db_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_int8q kernel launch failed: cudaError {err}")
    _launched("fused_topk_int8q")
    return vals, idx


def _int8q_topk(bank, q_scales: torch.Tensor, k: int):
    vals, idx = _bank_topk(*bank, k)
    # Fold the per-query scale back in, keeping the -1e30 sentinel of
    # masked slots (a tiny scale would shrink it past the callers' -1e29
    # filter).
    scaled = vals * q_scales[:, None]
    return torch.where(vals <= NEG_INF * 0.5, NEG_INF, scaled), idx


def fused_score_topk_int8q_reference(db_q, scales, queries, k: int, count=None, alive=None,
                                     *, banks: int = 8, keep2: bool = False):
    """Plain PyTorch version of `fused_score_topk_int8q`."""
    _check_quant(db_q, scales, queries, alive, banks, db_q.shape[1])
    q8, q_scales = quantize_rows_int8(queries)
    bank = int8q_bank_reference(db_q, scales, q8, count, alive, banks=banks, keep2=keep2)
    return _int8q_topk(bank, q_scales, k)


def fused_score_topk_int8q(db_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                           k: int, count=None, alive=None, *, banks: int = 8,
                           keep2: bool = False):
    """All-int8 fused MIPS: ([N, D] int8 rows, [N] row scales, [Q, D] float32
    queries) -> (vals [Q, k], idx [Q, k]). Queries are quantized per row on
    their device, scored s8 x s8 against the rows times the row scales,
    and their own scales are applied to the winners. `alive` masks
    tombstones in the scan; keep2 keeps the best two rows per slot."""
    _check_quant(db_q, scales, queries, alive, banks, db_q.shape[1])
    q8, q_scales = quantize_rows_int8(queries)
    bank_fn = (int8q_bank_reference if db_q.device.type == "cpu"
               else fused_score_bank_int8q_cuda)
    bank = bank_fn(db_q, scales, q8, count, alive, banks=banks, keep2=keep2)
    return _int8q_topk(bank, q_scales, k)


def fused_score_topk_int8q_rerank(db_q: torch.Tensor, scales: torch.Tensor,
                                  queries: torch.Tensor, k: int, count=None, alive=None, *,
                                  rerank: int = 64, banks: int = 4):
    """K2's coarse scan, then a bf16-query rerank on the same int8 rows
    (memex_tpu's `fused_score_topk_int8q_rerank`): the top R = min(rerank,
    banks * 128) of the int8-query scan, with `alive` masking tombstones
    inside the scan, re-scored by `_rerank`. (db_q [N, D] int8, scales [N]
    float32, queries [Q, D] float32) -> (vals [Q, k], idx [Q, k]).
    memex_tpu's `block_n` and `interpret` set the TPU kernel's tiling and
    its interpreter; K2's CUDA kernel has neither, so they are dropped."""
    r = min(rerank, banks * _LANES)
    cvals, cand = fused_score_topk_int8q(db_q, scales, queries, r, count, alive, banks=banks)
    return _rerank(cvals, cand, db_q, scales, queries, k, alive)


def fused_score_topk_int8q_rerank_reference(db_q, scales, queries, k: int, count=None,
                                            alive=None, *, rerank: int = 64, banks: int = 4):
    """Plain PyTorch version of `fused_score_topk_int8q_rerank`."""
    r = min(rerank, banks * _LANES)
    cvals, cand = fused_score_topk_int8q_reference(db_q, scales, queries, r, count, alive,
                                                   banks=banks)
    return _rerank(cvals, cand, db_q, scales, queries, k, alive)


# -- K3: int8 rows, bf16 queries -----------------------------------------------


def int8_bank_reference(db_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                        count=None, alive=None, *, banks: int = 8):
    """Plain version of K3's bank: bf16(q) x int8 rows (exact as bf16), f32
    accumulate, times the row scale; single-winner fold."""
    limit = _limit(db_q.shape[0], count)
    raw = scores_f32(queries, db_q[:limit].T, exact=False)
    return _fold_bank(raw * scales[None, :limit], alive, banks * _LANES, False)


def fused_score_bank_int8_cuda(db_q: torch.Tensor, scales: torch.Tensor,
                               queries: torch.Tensor, count=None, alive=None, *,
                               banks: int = 8):
    """Launch K3; returns the slot bank as ([vals], [idx])."""
    from ..kernels import library

    _check_quant(db_q, scales, queries, alive, banks, db_q.shape[1])
    queries = queries.contiguous()
    _need_cuda(db_q, scales, queries, *([alive] if alive is not None else []))
    lib = library()
    n, d = db_q.shape
    if d % 16 or d > lib.memex_fused_topk_int8_max_dim():
        raise ValueError(f"row dim {d} unsupported: the int8 kernels take dims that are "
                         f"multiples of 16, <= {lib.memex_fused_topk_int8_max_dim()}")
    S = banks * _LANES
    Q = queries.shape[0]
    with torch.cuda.device(db_q.device):
        vals, idx = _bank_outputs(db_q, Q, S, False)
        err = lib.memex_fused_topk_int8(
            queries.data_ptr(), db_q.data_ptr(), scales.data_ptr(),
            alive.data_ptr() if alive is not None else None,
            vals[0].data_ptr(), idx[0].data_ptr(), Q, d, S, _limit(n, count),
            torch.cuda.current_stream(db_q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_int8 kernel launch failed: cudaError {err}")
    _launched("fused_topk_int8")
    return vals, idx


def fused_score_topk_int8_reference(db_q, scales, queries, k: int, count=None, alive=None,
                                    *, banks: int = 8):
    """Plain PyTorch version of `fused_score_topk_int8`."""
    _check_quant(db_q, scales, queries, alive, banks, db_q.shape[1])
    return _bank_topk(*int8_bank_reference(db_q, scales, queries, count, alive,
                                           banks=banks), k)


def fused_score_topk_int8(db_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                          k: int, count=None, alive=None, *, banks: int = 8):
    """int8 fused MIPS with bf16 queries: ([N, D] int8, [N] f32, [Q, D]) ->
    (vals [Q, k], idx [Q, k]). `alive` masks tombstones in the scan."""
    if db_q.device.type == "cpu":
        return fused_score_topk_int8_reference(db_q, scales, queries, k, count, alive,
                                               banks=banks)
    return _bank_topk(*fused_score_bank_int8_cuda(db_q, scales, queries, count, alive,
                                                  banks=banks), k)


# -- K4: packed int4 rows, then an int8 rerank -----------------------------------


def _int4_query_operands(queries: torch.Tensor, deferred: bool):
    """The kernel's two query operands, from the int8-quantized queries
    (the query scale is dropped: ranking does not depend on it). Shift:
    the int8 halves q_lo = q8[:, :D/2], q_hi = q8[:, D/2:]. Deferred:
    bf16(q_lo) and bf16(q_hi - 16 q_lo) as float32 values."""
    q8, _ = quantize_rows_int8(queries)
    d2 = q8.shape[1] // 2
    q_lo, q_hi = q8[:, :d2], q8[:, d2:]
    if not deferred:
        return q_lo.contiguous(), q_hi.contiguous()
    lo_f = q_lo.float()
    in1 = lo_f.to(torch.bfloat16).float()
    in2 = (q_hi.float() - 16.0 * lo_f).to(torch.bfloat16).float()
    return in1.contiguous(), in2.contiguous()


def _check_int4(db_p, scales8, queries, alive, banks) -> None:
    _check_quant(db_p, scales8, queries, alive, banks, 2 * db_p.shape[1])


def int4q_candidates_reference(db_p: torch.Tensor, scales8: torch.Tensor,
                               queries: torch.Tensor, count=None, alive=None, *,
                               banks: int = 8, deferred: bool = False,
                               keep2: bool = False):
    """Plain version of K4's bank, as ([Q, S] vals, [Q, S] idx) (keep2:
    [Q, 2S]), the query scale not folded in. The unpack is the kernel's
    (hi = (b + 8) >> 4, lo = ((b + 8) & 15) - 8); both modes' dots are
    float32 matmuls of integer values below 2^24, hence exact."""
    _check_int4(db_p, scales8, queries, alive, banks)
    qa, qb = _int4_query_operands(queries, deferred)
    limit = _limit(db_p.shape[0], count)
    t = db_p[:limit].to(torch.int32) + 8
    hi = (t >> 4).float()
    if deferred:
        raw = (scores_f32(qa, db_p[:limit].T.float(), exact=True)
               + scores_f32(qb, hi.T, exact=True))
    else:
        lo = ((t & 15) - 8).float()
        raw = (scores_f32(qa.float(), lo.T, exact=True)
               + scores_f32(qb.float(), hi.T, exact=True))
    scales4 = scales8[:limit] * INT4_SCALE
    vals, idx = _fold_bank(raw * scales4[None, :], alive, banks * _LANES, keep2)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def int4_query_operands_cuda(queries: torch.Tensor, deferred: bool):
    """`_int4_query_operands` in one launch of the int4 scan's
    query-operand kernel (csrc/fused_topk_int4.cu): the same two tensors,
    bit for bit, from float32 queries on the card."""
    from ..kernels import library

    queries = queries.float().contiguous()
    _need_cuda(queries)
    Q, d = queries.shape
    with torch.cuda.device(queries.device):
        qa, qb = (torch.empty((Q, d // 2), device=queries.device,
                              dtype=torch.float32 if deferred else torch.int8)
                  for _ in range(2))
        err = library().memex_int4_query_operands(
            queries.data_ptr(), qa.data_ptr(), qb.data_ptr(), Q, d, int(deferred),
            torch.cuda.current_stream(queries.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4 query-operand kernel launch failed: cudaError {err}")
    return qa, qb


def int4q_candidates_cuda(db_p: torch.Tensor, scales8: torch.Tensor, queries: torch.Tensor,
                          count=None, alive=None, *, banks: int = 8,
                          deferred: bool = False, keep2: bool = False):
    """Launch K4; returns its bank as in `int4q_candidates_reference`."""
    from ..kernels import library

    _check_int4(db_p, scales8, queries, alive, banks)
    _need_cuda(db_p, scales8, *([alive] if alive is not None else []))
    lib = library()
    n, d2 = db_p.shape
    d = 2 * d2
    if d % 32 or d > lib.memex_fused_topk_int4q_max_dim():
        raise ValueError(f"row dim {d} unsupported: the int4 kernel takes dims that are "
                         f"multiples of 32, <= {lib.memex_fused_topk_int4q_max_dim()}")
    S = banks * _LANES
    Q = queries.shape[0]
    with torch.cuda.device(db_p.device):
        # Outputs first, so the two launches follow each other closely.
        vals, idx = _bank_outputs(db_p, Q, S, keep2)
        qa, qb = int4_query_operands_cuda(queries, deferred)
        err = lib.memex_fused_topk_int4q(
            qa.data_ptr(), qb.data_ptr(), db_p.data_ptr(), scales8.data_ptr(), INT4_SCALE,
            alive.data_ptr() if alive is not None else None,
            vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None,
            idx[-1].data_ptr() if keep2 else None,
            Q, d, S, _limit(n, count), int(deferred), int(keep2),
            torch.cuda.current_stream(db_p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_int4q kernel launch failed: cudaError {err}")
    _launched("fused_topk_int4q")
    if not keep2:
        return vals[0], idx[0]
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def int4q_candidates(db_p: torch.Tensor, scales8: torch.Tensor, queries: torch.Tensor,
                     count=None, alive=None, *, banks: int = 8, deferred: bool = False,
                     keep2: bool = False):
    """K4's candidate bank (memex_tpu's `_int4q_candidates`): packed rows
    db_p [N, D/2] int8, int8 row scales [N], float32 queries [Q, D]."""
    fn = int4q_candidates_reference if db_p.device.type == "cpu" else int4q_candidates_cuda
    return fn(db_p, scales8, queries, count, alive, banks=banks, deferred=deferred,
              keep2=keep2)


def _rerank(cvals, cand, db8, scales8, queries, k: int, alive):
    """Coarse candidates cand [Q, R] (their values cvals), re-scored exactly
    against the int8 rows: bf16 queries x int8 rows, float32 accumulate,
    times the row scale; then a stable top-k (ties to the lower slot, as
    `lax.top_k`). Slots the coarse scan masked and dead rows score -1e30."""
    cand = cand.long()
    rows = db8[cand]                                 # [Q, R, D]
    rer = scores_f32(queries[:, None, :], rows.transpose(1, 2), exact=False)[:, 0]
    rer = rer * scales8[cand]
    ok = cvals > NEG_INF * 0.5  # count mask
    if alive is not None:
        ok = ok & (alive[cand] > 0)
    rer = torch.where(ok, rer, NEG_INF)
    vals, args = exact_topk(rer, k)
    return vals, torch.gather(cand, 1, args.long()).to(torch.int32)


def _int4_rerank(cand_vals, cand_idx, db8, scales8, queries, k: int, alive, rerank: int):
    """Top-R of the coarse bank (a stable order), then `_rerank`."""
    r = min(rerank, cand_vals.shape[1])
    order = torch.sort(-cand_vals, dim=1, stable=True).indices[:, :r]
    return _rerank(torch.gather(cand_vals, 1, order), torch.gather(cand_idx, 1, order),
                   db8, scales8, queries, k, alive)


def fused_score_topk_int4_rerank(db_p: torch.Tensor, scales8: torch.Tensor, db8: torch.Tensor,
                                 queries: torch.Tensor, k: int, count=None, alive=None, *,
                                 rerank: int = 64, banks: int = 8, deferred: bool = False,
                                 keep2: bool = False):
    """Two-stage search: the int4 coarse scan (K4), then the exact int8
    rerank of its top `rerank` candidates. (db_p [N, D/2] packed int8,
    scales8 [N] int8 row scales, db8 [N, D] int8, queries [Q, D] float32)
    -> (vals [Q, k], idx [Q, k]). `alive` masks tombstones in the scan and
    again on the candidates."""
    cand_vals, cand_idx = int4q_candidates(db_p, scales8, queries, count, alive, banks=banks,
                                           deferred=deferred, keep2=keep2)
    return _int4_rerank(cand_vals, cand_idx, db8, scales8, queries, k, alive, rerank)


def fused_score_topk_int4_rerank_reference(db_p, scales8, db8, queries, k: int, count=None,
                                           alive=None, *, rerank: int = 64, banks: int = 8,
                                           deferred: bool = False, keep2: bool = False):
    """Plain PyTorch version of `fused_score_topk_int4_rerank`."""
    cand_vals, cand_idx = int4q_candidates_reference(
        db_p, scales8, queries, count, alive, banks=banks, deferred=deferred, keep2=keep2)
    return _int4_rerank(cand_vals, cand_idx, db8, scales8, queries, k, alive, rerank)
