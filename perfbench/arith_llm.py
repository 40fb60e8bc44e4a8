"""Frozen arithmetic of the local-LLM cell: DeepSeek-V2-Lite's operations
in a prefill and the bytes a decode step must read, from its published
widths (deepseek-ai/DeepSeek-V2-Lite config.json), so that a later change
to the program cannot move the yardstick. Peaks are arith.py's."""

from __future__ import annotations

LAYERS = 27
HIDDEN = 2048
HEADS = 16
QK_HEAD = 128 + 64            # qk_nope_head_dim + qk_rope_head_dim
V_HEAD = 128
KV_LORA = 512
LATENT = KV_LORA + 64         # a position's cache row: c_kv and k_pe
DENSE_WIDTH = 10944           # layer 0 (first_k_dense_replace 1)
EXPERT_WIDTH = 1408
EXPERTS = 64
TOP_K = 6
SHARED_WIDTH = 2 * EXPERT_WIDTH
VOCAB = 102400
BF16 = 2

# Matmul parameters a layer's attention applies to a token: q, kv_a, kv_b, o.
ATTN_PARAMS = (HIDDEN * HEADS * QK_HEAD + HIDDEN * LATENT + KV_LORA * HEADS * (128 + V_HEAD)
               + HEADS * V_HEAD * HIDDEN)
DENSE_PARAMS = 3 * HIDDEN * DENSE_WIDTH
# A MoE layer for one token: the router, its 6 routed experts, the shared ones.
MOE_PARAMS = HIDDEN * EXPERTS + TOP_K * 3 * HIDDEN * EXPERT_WIDTH + 3 * HIDDEN * SHARED_WIDTH
HEAD_PARAMS = HIDDEN * VOCAB
# Without the head (a prefill computes it at one row): ~2.24B.
TOKEN_PARAMS = LAYERS * ATTN_PARAMS + DENSE_PARAMS + (LAYERS - 1) * MOE_PARAMS
# What a decode step reads at least, head included: ~2.45B.
DECODE_PARAMS = TOKEN_PARAMS + HEAD_PARAMS


def prefill_flops(prompt_lengths) -> float:
    """Operations of prefills of these real prompt lengths: 2 x TOKEN_PARAMS
    a token, and MLA's products 2 * heads * (192 + 128) * (t + 1) a layer
    at position t (each query against its causal prefix)."""
    total = 0.0
    for n in prompt_lengths:
        n = int(n)
        attention = LAYERS * 2.0 * HEADS * (QK_HEAD + V_HEAD) * n * (n + 1) / 2
        total += 2.0 * TOKEN_PARAMS * n + attention
    return total


def decode_bytes(asks) -> float:
    """Bytes the decode steps of asks [(prompt ids n, steps A)] must read:
    DECODE_PARAMS bf16 weights a step, and the latent cache of every
    position before the step's, 27 * pos * 576 * 2 at pos = n .. n + A - 1.
    A lower bound: it leaves out activations, norms and cache writes."""
    total = 0.0
    for n, steps in asks:
        n, steps = int(n), int(steps)
        positions = steps * n + steps * (steps - 1) / 2
        total += steps * DECODE_PARAMS * BF16 + LAYERS * LATENT * BF16 * positions
    return total
