"""The comparison that decides `correct`, and the controls it must fail.

Search cells: for a seeded sample of the searches completed in the
window, the reference embeds each query text (its own WordPiece, float32
MiniLM) and scores every row, made again from the seed block by block, in
float32. A returned id counts as a hit when its true score reaches the
reference's 10th best (tie-aware, as PERF.md's recall is). A query's gap
is how far its worst returned row falls below that 10th best; an id that
names no row, a repeated id or a short list gives an infinite gap. The
number compared is the widest gap of the sample; recall@10 is the mean
hit share.

The control puts the reference in the program's place one precision
step below the stored int8 rows: rows quantized to int4 (a scale a row,
max |x| / 7), exact float32 products against the reference's query. Its
top-k ids are judged by `search_readings` as the program's are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .corpus import Corpus, row_of
from .reference import minilm as ref_minilm


def _quant_int4(v: torch.Tensor) -> torch.Tensor:
    s = v.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 7.0
    return torch.clamp(torch.round(v / s), -7, 7) * s


def control_ids(corpus: Corpus, weights: dict, model_cfg: dict, texts: list[str],
                k: int = 10) -> list[list[str]]:
    """The control's answers: the ids of each query's top k over int4 rows."""
    ref_minilm.no_tf32()
    q = ref_minilm.encode_ids(weights, model_cfg, [corpus.tok.encode(t) for t in texts],
                              corpus.tok.pad)
    key = torch.full((len(texts), k), -math.inf, device=corpus.device)
    idx = torch.zeros((len(texts), k), dtype=torch.long, device=corpus.device)
    for b in range(corpus.n_blocks):
        v, _ = corpus.block(b)
        bv, bi = torch.topk(q @ _quant_int4(v).T, min(k, v.shape[0]), dim=1)
        kv, ki = torch.topk(torch.cat([key, bv], 1), k, dim=1)
        key, idx = kv, torch.gather(torch.cat([idx, bi + b * corpus.BLOCK], 1), 1, ki)
        del bv, bi, v
    return [[f"r{i:09d}" for i in row] for row in idx.cpu().tolist()]


def search_readings(corpus: Corpus, weights: dict, model_cfg: dict,
                    sample: list[tuple[str, list]], k: int = 10) -> dict:
    """Gaps and recall of the returned ids in `sample` [(query text, ids)]."""
    ref_minilm.no_tf32()
    dev = corpus.device
    q = ref_minilm.encode_ids(weights, model_cfg, [corpus.tok.encode(t) for t, _ in sample],
                              corpus.tok.pad)
    S = len(sample)
    given = np.full((S, k), -1, np.int64)
    bad = np.zeros(S, bool)
    for i, (_, ids) in enumerate(sample):
        rows = [row_of(s) for s in ids[:k]]
        if len(ids) < k or len(set(ids[:k])) < k or min(rows, default=-1) < 0 \
                or max(rows, default=0) >= corpus.n_rows:
            bad[i] = True
        given[i, : len(rows)] = rows
    given_t = torch.from_numpy(given).to(dev)
    got = torch.full((S, k), -math.inf, device=dev)      # true scores of `given`
    top = torch.full((S, k), -math.inf, device=dev)      # true top-k values
    for b in range(corpus.n_blocks):
        v, _ = corpus.block(b)
        lo = b * corpus.BLOCK
        s = q @ v.T
        top = torch.topk(torch.cat([top, s], 1), k, dim=1).values
        local = given_t - lo
        inb = (local >= 0) & (local < v.shape[0])
        got = torch.where(inb, torch.gather(s, 1, local.clamp(0, v.shape[0] - 1)), got)
        del s, v
    kth = top[:, -1:]
    gap = (kth - got.min(dim=1, keepdim=True).values).clamp_min(0).squeeze(1).cpu().numpy()
    hits = (got >= kth).sum(dim=1).cpu().numpy() / k
    gap[bad] = math.inf
    hits[bad] = 0.0
    return {"worst_gap": float(gap.max()), "gap_p99": float(np.percentile(gap, 99)),
            "gap_median": float(np.median(gap)), "recall_at_10": float(hits.mean()),
            "n": S, "bad": int(bad.sum())}


def sample_of(completed: list, n: int, seed_rng: np.random.Generator) -> list:
    if len(completed) <= n:
        return list(completed)
    idx = seed_rng.choice(len(completed), n, replace=False)
    return [completed[i] for i in sorted(idx)]
