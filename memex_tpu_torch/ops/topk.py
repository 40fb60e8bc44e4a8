"""Top-k over a score matrix, and one-shot scoring (port of
memex_tpu/ops/topk.py).

Ties break by lower column, as `lax.top_k` does: every function sorts
stably, so equal scores keep their column order on every device. Inputs
are unit vectors, so an inner product is a cosine.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def scores_f32(queries: torch.Tensor, rows_t: torch.Tensor, exact: bool) -> torch.Tensor:
    """queries [..., Q, D] @ rows_t [..., D, N] as a float32 matmul. Non-exact
    mode rounds both inputs to bf16 first (a bf16 x bf16 product is exact in
    float32, so this is the bf16-in, f32-accumulate dot of the kernels and
    of the TPU's matrix unit); exact mode keeps float32 inputs. Neither may
    run in TF32. Integer-valued inputs give the exact integer dot in either
    mode while every partial sum stays below 2^24."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 scoring needs true float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    if not exact:
        queries = queries.to(torch.bfloat16)
        rows_t = rows_t.to(torch.bfloat16)
    return queries.float() @ rows_t.float()


def _mask_scores(scores: torch.Tensor, count) -> torch.Tensor:
    """Mask columns >= count (unfilled capacity rows) to -1e30."""
    col = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(col < count, scores, torch.full_like(scores, NEG_INF))


def _stable_topk(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def exact_topk(scores: torch.Tensor, k: int, count=None):
    """Full-sort exact top-k ([Q, N] -> vals, idx [Q, k]). The recall oracle."""
    if count is not None:
        scores = _mask_scores(scores, count)
    return _stable_topk(scores, k)


def blockwise_topk(scores: torch.Tensor, k: int, count=None, block: int = 4096):
    """Two-stage exact top-k: per-block top-k, then top-k over the block
    winners. Same result as `exact_topk`, ties included: winners are laid
    out in block order, so the stable second sort still prefers the lower
    column."""
    q, n = scores.shape
    if count is not None:
        scores = _mask_scores(scores, count)
    if n <= block:
        return _stable_topk(scores, k)
    nblocks = -(-n // block)
    pad = nblocks * block - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    vals, idx = _stable_topk(scores.reshape(q, nblocks, block), min(k, block))
    base = (torch.arange(nblocks, device=scores.device, dtype=torch.int32)
            * block)[None, :, None]
    idx = (idx + base).reshape(q, -1)
    fvals, fargs = _stable_topk(vals.reshape(q, -1), k)
    return fvals, torch.gather(idx, 1, fargs.long())


def approx_topk(scores: torch.Tensor, k: int, count=None, recall_target: float = 0.95):
    """memex_tpu's approximate top-k. There it is `lax.approx_max_k`, a TPU
    PartialReduce op; off the TPU, XLA computes the exact top-k, and so
    does memex_tpu's own CPU run. The port returns the exact stable top-k
    of the masked scores with int32 indices; `recall_target` is taken and
    has no effect, since there is no approximate algorithm here to tune."""
    return exact_topk(scores, k, count)


def score_topk(db: torch.Tensor, queries: torch.Tensor, k: int, count=None,
               method: str = "blockwise", block: int = 4096):
    """One-shot scoring: [N, D] x [Q, D] -> (vals [Q, k], idx [Q, k]).

    `exact_f32` scores in true float32 (TF32 refused), the recall oracle.
    The other methods (`blockwise`, the default, `exact` and `approx`)
    round both operands to bf16 and accumulate in float32, as memex_tpu's
    bf16 einsum on the TPU's matrix unit does; they differ only in how
    they take the top k, and all three give the same exact answer here.
    A method memex_tpu does not name falls to `blockwise`, as there."""
    exact = method == "exact_f32"
    scores = scores_f32(queries, db.T, exact=exact)
    if exact or method == "exact":
        return exact_topk(scores, k, count)
    if method == "approx":
        return approx_topk(scores, k, count)
    return blockwise_topk(scores, k, count, block=block)
