"""Are the refine tiers' last misses structural? (memex_tpu's
benchmarks/int4_bank_sweep2.py on CUDA cards, 1M x 384.) The exact
(query, row) pairs of the oracle's top 10 that each coarse bank loses
after `_exact_flat_rerank` from coarse + residual codes: int8q (K2) at
S = 512 and 1024, int4 (K4, deferred unpack) at S = 2048 and 4096. The
same rows lost at every S would mean a rank-10/11 gap below every
format's resolution, not slot pressure; the oracle's smallest and median
gap are printed first.

    python -m memex_tpu_torch.benchmarks.int4_bank_sweep2 [--device cuda|cpu]

Prints {"min_boundary_gap", "median_boundary_gap"}, one {"variant",
"recall", "misses"} a variant, then {"common_int8q_b4_int4_b16",
"union_sizes", "elapsed_s"}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..index.flat import _exact_flat_rerank
from ..ops.fused_topk import fused_score_topk_int4_rerank, fused_score_topk_int8q
from . import flat_sweep as fs

VARIANTS = (("int8q_b4", "int8q", 4), ("int8q_b8", "int8q", 8),
            ("int4_b16", "int4", 16), ("int4_b32", "int4", 32))


def main(device="cuda", n: int = fs.N) -> dict:
    """The gaps, each variant's misses and the summary, printed; returns
    {"gaps": ..., "variants": [...], "summary": ...}."""
    c = fs.make_case(device, n, batches=1)
    gaps = {"min_boundary_gap": float(c.gaps.min()),
            "median_boundary_gap": float(np.median(c.gaps))}
    print(json.dumps(gaps), flush=True)

    def fn_of(kind, banks):
        def fn(q):
            if kind == "int4":
                vals, idx = fused_score_topk_int4_rerank(c.db4, c.scales, c.db8, q, 64,
                                                         count=n, rerank=128, banks=banks,
                                                         deferred=True)
            else:
                vals, idx = fused_score_topk_int8q(c.db8, c.scales, q, 64, count=n,
                                                   banks=banks)
            return _exact_flat_rerank(c.db8, c.scales, q, vals, idx, fs.K, rbuf=c.rq8,
                                      rbuf_scales=c.rsc2)
        return fn

    t0 = time.perf_counter()
    variants, lost = [], []
    for name, kind, banks in VARIANTS:
        fi = fn_of(kind, banks)(c.oracle_q)[1][:fs.Q].cpu().numpy()
        miss = [(int(qi), int(r)) for qi in range(fs.Q)
                for r in sorted(set(c.ei[qi].tolist()) - set(fi[qi].tolist()))]
        row = {"variant": name, "recall": round(1.0 - len(miss) / (fs.Q * fs.K), 4),
               "misses": miss}
        print(json.dumps(row), flush=True)
        variants.append(row)
        lost.append(miss)
    summary = {"common_int8q_b4_int4_b16": sorted(set(lost[0]) & set(lost[2])),
               "union_sizes": [len(m) for m in lost],
               "elapsed_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(summary), flush=True)
    return {"gaps": gaps, "variants": variants, "summary": summary}


if __name__ == "__main__":
    sys.exit(fs.cli(main, "int4_bank_sweep2"))
