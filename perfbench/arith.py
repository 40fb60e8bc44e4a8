"""Frozen metric arithmetic: the H100's published peaks, the bytes the
scans K2 and K5 must move, and the encoder's operations.

The peaks and byte counts are copied from memex_tpu_torch/scan_bench.py
(`HBM_BYTES_PER_S`, `PEAK_OPS_PER_S`, `k2_bound`, `k5_bound`) and
memex_tpu_torch/bench.py (`_roofline`), so that a later change to the
program cannot move the yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_PER_S = {                 # dense, NVIDIA's data sheet, at 700 W
    "bf16": 989e12,
    "int8": 1979e12,
    "fp32": 67e12,
}
DIM = 384


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    """The least seconds the card could take to move n_bytes and do n_ops
    operations of `kind`."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


def k2_bytes(q_n: int, live: int, limit: int, n_slots: int = 512) -> float:
    """K2 (`fused_score_topk_int8q`): live int8 rows with their float32
    scales and the alive entries below `limit` read, the int8 queries and
    their scales read, the [Q, S] candidate bank written."""
    return live * (DIM + 4) + limit * 4 + q_n * (DIM + 4) + q_n * n_slots * 8


def k2_bound_s(q_n: int, live: int, limit: int, n_slots: int = 512) -> float:
    return bound_s(k2_bytes(q_n, live, limit, n_slots), 2.0 * q_n * live * DIM, "int8")


def k5_bytes(q_n: int, live: int, n_chunks: int, n_clusters: int,
             n_slots: int = 1024) -> float:
    """K5 (`ivf_batch_search`, int8 buckets): the probed union's live rows
    and their scales, its chunk walk and the bucket sizes read, the float32
    queries read, the [Q, S] bank written."""
    return (live * (DIM + 4) + n_chunks * 4 + n_clusters * 4 + q_n * DIM * 4
            + q_n * n_slots * 8)


def k5_bound_s(q_n: int, live: int, n_chunks: int, n_clusters: int,
               n_slots: int = 1024) -> float:
    return bound_s(k5_bytes(q_n, live, n_chunks, n_clusters, n_slots),
                   2.0 * q_n * live * DIM, "bf16")


def encoder_flops_per_token(seq_len: int, hidden: int = 384, intermediate: int = 1536,
                            layers: int = 12) -> float:
    """Multiply-adds x 2 a token of a BERT encoder at attention length
    `seq_len`: the Q, K, V and output projections (8 H^2), the two FFN
    products (4 H I) and the two attention products (4 L H), each layer.
    About 47.2 MFLOP at L = 256 for all-MiniLM-L12-v2."""
    return layers * (8.0 * hidden * hidden + 4.0 * hidden * intermediate
                     + 4.0 * seq_len * hidden)


def encoder_flops(lengths) -> float:
    """Operations to encode sequences of these real token counts, each
    attending over its own length (padding excluded)."""
    return float(sum(n * encoder_flops_per_token(n) for n in lengths))
