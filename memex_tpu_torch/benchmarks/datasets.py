"""Synthetic corpora for recall/QPS benchmarking (port of
memex_tpu/benchmarks/datasets.py; the numpy draws are the same, bit for
bit, for every kind and seed).

Two regimes:
  - `uniform`: iid unit vectors — IVF's worst case, flat's neutral case;
  - `clustered`: mixture-of-gaussians on the sphere — the realistic regime
    for sentence embeddings (what MiniLM output actually looks like).

Queries are perturbed corpus rows (`query_noise`), matching the semantic-
search workload where queries are near their relevant documents.
"""

from __future__ import annotations

import numpy as np


def unit_rows(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def make_corpus(
    n: int,
    dim: int = 384,
    kind: str = "clustered",
    n_centers: int = 256,
    center_noise: float = 0.75,
    seed: int = 0,
) -> np.ndarray:
    """`center_noise` is the NORM of the per-point offset (the per-dim
    stddev is center_noise/sqrt(dim)); cos(point, center) ~ 1/sqrt(1+cn^2),
    so 0.75 -> ~0.8, matching intra-topic similarity of real sentence
    embeddings. (An un-normalized per-dim stddev would drown the centers
    at high dim and silently degenerate to the uniform regime.)"""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return unit_rows(rng.standard_normal((n, dim), dtype=np.float32))
    centers = unit_rows(rng.standard_normal((n_centers, dim), dtype=np.float32))
    assign = rng.integers(0, n_centers, size=n)
    sigma = center_noise / np.sqrt(dim)
    x = centers[assign] + sigma * rng.standard_normal((n, dim)).astype(np.float32)
    return unit_rows(x)


def make_queries(
    corpus: np.ndarray, q: int, query_noise: float = 0.5, seed: int = 1
) -> np.ndarray:
    """`query_noise` is the offset norm (see make_corpus)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, corpus.shape[0], size=q)
    sigma = query_noise / np.sqrt(corpus.shape[1])
    x = corpus[rows] + sigma * rng.standard_normal(
        (q, corpus.shape[1])
    ).astype(np.float32)
    return unit_rows(x)


def oracle_topk(corpus: np.ndarray, queries: np.ndarray, k: int,
                device="cuda") -> np.ndarray:
    """Exact f32 ground truth [Q, k].

    Corpora past 2,000,000 rows run blocked on `device` (exact f32 scores,
    merged on the host): the numpy path needs ~45 min for 10M x 384 on one
    core. Smaller ones stay on the host, and `device` is not touched."""
    n = corpus.shape[0]
    if n > 2_000_000:
        return _oracle_topk_device(corpus, queries, k, device)
    out = np.empty((queries.shape[0], k), np.int64)
    B = 8192
    scores = np.empty((queries.shape[0], n), np.float32)
    for s in range(0, n, B):
        scores[:, s : s + B] = queries @ corpus[s : s + B].T
    out[:] = np.argpartition(-scores, k, axis=1)[:, :k]
    # order within top-k
    row = np.arange(queries.shape[0])[:, None]
    order = np.argsort(-scores[row, out], axis=1)
    return out[row, order]


def _oracle_topk_device(corpus: np.ndarray, queries: np.ndarray, k: int,
                        device="cuda", block: int = 1_048_576) -> np.ndarray:
    """Blocked `score_topk(method="exact_f32")` on `device`: true float32
    scores (TF32 is refused), one block of rows resident at a time, each
    block's top-k merged on the host by a stable sort, so a tie goes to the
    lower row, as within a block."""
    import torch

    from ..ops.host import fetch
    from ..ops.topk import score_topk

    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    vals_parts, idx_parts = [], []
    for s in range(0, corpus.shape[0], block):
        rows = torch.from_numpy(np.ascontiguousarray(corpus[s : s + block], np.float32))
        bv, bi = fetch(*score_topk(rows.to(device), q, k, method="exact_f32"))
        vals_parts.append(bv)
        idx_parts.append(bi.astype(np.int64) + s)
    vals = np.concatenate(vals_parts, axis=1)
    idx = np.concatenate(idx_parts, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(idx, order, axis=1)
