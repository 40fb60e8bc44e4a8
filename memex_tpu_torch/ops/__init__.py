"""Scoring ops of the flat scan: top-k over scores, one-shot scoring and
the fused score+top-k kernel (CUDA for tensors on the card, its plain
PyTorch version on the CPU)."""

from .fused_topk import fused_score_topk
from .topk import approx_topk, blockwise_topk, exact_topk, score_topk

__all__ = [
    "exact_topk",
    "blockwise_topk",
    "approx_topk",
    "score_topk",
    "fused_score_topk",
]
