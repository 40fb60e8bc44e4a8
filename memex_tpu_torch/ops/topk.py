"""Exact top-k over a score matrix (port of memex_tpu/ops/topk.py).

Ties break by lower column, as `lax.top_k` does: both functions sort
stably, so equal scores keep their column order on every device.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
