"""The (kk, k_ret) grid of the refine tiers at 1M x 384 (memex_tpu's
benchmarks/int4_refine_sweep.py on CUDA cards): `_search_rerank_fused`
for int4+refine (K4, deferred unpack, S = 2048, keep2) and int8q+refine
(K2, S = 512, keep2), with `kk` candidates reranked from coarse + residual
codes and `k_ret` kept for the final top 10. The script asked whether
deeper reranks lift int4+refine's recall to int8q's at >= 0.99.

    python -m memex_tpu_torch.benchmarks.int4_refine_sweep [--device cuda|cpu]

Prints one JSON row a variant (variant, qps, p50_batch_ms, recall_at_10),
then {"sweep": rows}.
"""

from __future__ import annotations

import json
import sys

from ..index.flat import _search_rerank_fused
from . import flat_sweep as fs

INT4_GRID = ((128, 64), (256, 128), (512, 128), (512, 256), (1024, 256))
INT8Q_GRID = ((64, 64), (128, 128), (256, 128))


def main(device="cuda", n: int = fs.N, *, batches: int = fs.R, reps: int = fs.REPS) -> list:
    """The grid's rows, printed and returned."""
    c = fs.make_case(device, n, batches)
    rows = []
    # The script's positional arguments: banks4 and keep2 keep their
    # defaults (16, True).
    for kk, kret in INT4_GRID:
        rows.append(fs.timed_row(c, f"int4_refine_kk{kk}_ret{kret}", (
            lambda q, kk=kk, kret=kret: _search_rerank_fused(
                c.db4, c.scales, c.db8, c.rq8, c.rsc2, None, n, q, fs.K, kret, kk, 32768,
                True, True, "int4", False)), reps=reps, with_compile=False))
    for kk, kret in INT8Q_GRID:
        rows.append(fs.timed_row(c, f"int8q_refine_kk{kk}_ret{kret}", (
            lambda q, kk=kk, kret=kret: _search_rerank_fused(
                c.db8, c.scales, None, c.rq8, c.rsc2, None, n, q, fs.K, kret, kk, 8192,
                True, False, "int8", False)), reps=reps, with_compile=False))
    print(json.dumps({"sweep": rows}), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(fs.cli(main, "int4_refine_sweep"))
