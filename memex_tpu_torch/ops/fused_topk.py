"""Fused brute-force MIPS top-k: the flat index's scan.

Port of memex_tpu/ops/fused_topk.py::fused_score_topk (kernel K1,
`_fused_kernel` + `_fold_chunks`). For Q queries against N rows it
computes the scores, masks columns >= `count` and dead rows to -1e30,
and folds column c into slot c mod S (S = banks * 128) of a per-query
bank, keeping each slot's best value (keep2: its best two, in the exact
single-insertion order of the TPU fold). The [Q, S] (keep2: [Q, 2S])
bank is then sorted stably to the top-k, as the JAX wrapper does outside
its kernel.

The tensor's device picks the implementation: rows on the card launch the
hand-written CUDA kernel (csrc/fused_topk.cu) or raise; rows on the CPU
run `fused_score_topk_reference`, the plain PyTorch version that folds in
the same order. A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import torch

from memex_tpu.metrics import METRICS

NEG_INF = -1e30
_LANES = 128

# Kernel launches made by `fused_score_topk` in this process. Callers
# reset and read it to prove a path went through the CUDA kernel.
LAUNCHES = 0


def _check(db: torch.Tensor, queries: torch.Tensor, alive, banks: int) -> None:
    if db.ndim != 2 or db.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"db must be a 2-D float32 or bfloat16 tensor, got "
                        f"{tuple(db.shape)} {db.dtype}")
    if queries.ndim != 2 or queries.dtype != torch.float32:
        raise TypeError(f"queries must be a 2-D float32 tensor, got "
                        f"{tuple(queries.shape)} {queries.dtype}")
    if queries.shape[1] != db.shape[1]:
        raise ValueError(f"query dim {queries.shape[1]} != row dim {db.shape[1]}")
    if queries.device != db.device:
        raise ValueError(f"queries on {queries.device}, rows on {db.device}")
    if alive is not None and (alive.shape != (db.shape[0],)
                              or alive.dtype != torch.float32
                              or alive.device != db.device):
        raise ValueError("alive must be a float32 [N] tensor on the rows' device")
    if banks < 1:
        raise ValueError(f"banks must be >= 1, got {banks}")


def scores_f32(queries: torch.Tensor, rows_t: torch.Tensor, exact: bool) -> torch.Tensor:
    """queries [..., Q, D] @ rows_t [..., D, N] as a float32 matmul. Non-exact
    mode rounds both inputs to bf16 first (a bf16 x bf16 product is exact in
    float32, so this is the bf16-in, f32-accumulate dot of the kernels);
    exact mode keeps float32 inputs. Neither may run in TF32."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 scoring needs true float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    if not exact:
        queries = queries.to(torch.bfloat16)
        rows_t = rows_t.to(torch.bfloat16)
    return queries.float() @ rows_t.float()


def _limit(n: int, count) -> int:
    return n if count is None else max(0, min(int(count), n))


def _bank_topk(bank_v: list[torch.Tensor], bank_i: list[torch.Tensor], k: int):
    """Exact top-k over the candidate bank: a stable descending order, so
    equal values keep bank order (jnp.argsort(-vals) in the JAX wrapper)."""
    vals = torch.cat(bank_v, dim=1)
    idx = torch.cat(bank_i, dim=1)
    order = torch.sort(-vals, dim=1, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def fused_score_topk_reference(db: torch.Tensor, queries: torch.Tensor, k: int,
                               count=None, alive=None, *, banks: int = 8,
                               exact: bool = False, keep2: bool = False):
    """Plain PyTorch version of the kernel: same inputs, same fold order,
    same (vals [Q, k], idx [Q, k]), scored by `scores_f32`."""
    _check(db, queries, alive, banks)
    n = db.shape[0]
    S = banks * _LANES
    limit = _limit(n, count)
    exact = exact and db.dtype == torch.float32
    # Columns past `limit` never change a slot (-1e30 never beats the
    # -1e30 init), so the fold stops at the fill level.
    scores = scores_f32(queries, db[:limit].T, exact)
    if alive is not None:
        scores = torch.where(alive[None, :limit] > 0, scores,
                             torch.full_like(scores, NEG_INF))
    G = -(-limit // S)
    if G * S != limit:
        scores = torch.nn.functional.pad(scores, (0, G * S - limit), value=NEG_INF)
    Q = queries.shape[0]
    acc_v = torch.full((Q, S), NEG_INF, dtype=torch.float32, device=db.device)
    acc_i = torch.zeros((Q, S), dtype=torch.int32, device=db.device)
    acc_v2, acc_i2 = acc_v.clone(), acc_i.clone()
    slot = torch.arange(S, dtype=torch.int32, device=db.device)[None, :]
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
        return _bank_topk([acc_v, acc_v2], [acc_i, acc_i2], k)
    return _bank_topk([acc_v], [acc_i], k)


def fused_score_bank_cuda(db: torch.Tensor, queries: torch.Tensor, count=None,
                          alive=None, *, banks: int = 8, exact: bool = False,
                          keep2: bool = False):
    """Launch the CUDA kernel; returns the slot bank as ([vals], [idx])
    lists of [Q, S] tensors (two of each with keep2). Raises on anything
    the kernel does not take, and on a refused launch."""
    global LAUNCHES
    import ctypes

    from ..kernels import library

    _check(db, queries, alive, banks)
    if not db.is_cuda:
        raise ValueError(f"the CUDA kernel needs tensors on the card, got {db.device}")
    lib = library()
    n, d = db.shape
    if d % 2 or d > lib.memex_fused_topk_max_dim():
        raise ValueError(f"row dim {d} unsupported: the kernel takes even dims "
                         f"<= {lib.memex_fused_topk_max_dim()}")
    S = banks * _LANES
    if not db.is_contiguous():
        raise ValueError("db must be contiguous")
    if alive is not None and not alive.is_contiguous():
        raise ValueError("alive must be contiguous")
    queries = queries.contiguous()
    Q = queries.shape[0]
    exact = exact and db.dtype == torch.float32
    with torch.cuda.device(db.device):
        kw = dict(dtype=torch.float32, device=db.device)
        vals = [torch.empty((Q, S), **kw) for _ in range(2 if keep2 else 1)]
        idx = [torch.empty((Q, S), dtype=torch.int32, device=db.device)
               for _ in range(2 if keep2 else 1)]
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = lib.memex_fused_topk(
            queries.data_ptr(), db.data_ptr(), int(db.dtype == torch.bfloat16),
            alive.data_ptr() if alive is not None else None,
            vals[0].data_ptr(), idx[0].data_ptr(),
            vals[-1].data_ptr() if keep2 else None,
            idx[-1].data_ptr() if keep2 else None,
            Q, d, S, ctypes.c_longlong(_limit(n, count)), int(exact),
            int(keep2), stream)
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    METRICS.inc("kernels.fused_topk.launches")
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
