"""The int4 refine tier's recall ceiling at 1M x 384 (memex_tpu's
benchmarks/int4_bank_sweep.py on CUDA cards): K4 through
`fused_score_topk_int4_rerank` (top 64 of an int8 rerank of 128
candidates) at S = 1024 and 2048 (banks 8 and 16) in deferred and shift
unpack, then `_exact_flat_rerank` from coarse + residual codes. The
script's two hypotheses for the loss: slot shadowing (fewer rows a slot
at banks 16) and the deferred unpack's bf16 rounding (shift is exact).

    python -m memex_tpu_torch.benchmarks.int4_bank_sweep [--device cuda|cpu]

Prints one JSON row a variant (variant, qps, p50_batch_ms, recall_at_10,
compile_s), then {"sweep": rows}.
"""

from __future__ import annotations

import json
import sys

from ..index.flat import _exact_flat_rerank
from ..ops.fused_topk import fused_score_topk_int4_rerank
from . import flat_sweep as fs

VARIANTS = (("b8_deferred", 8, True),        # memex_tpu's operating point
            ("b8_exact_unpack", 8, False),
            ("b16_deferred", 16, True),
            ("b16_exact_unpack", 16, False))


def main(device="cuda", n: int = fs.N, *, batches: int = fs.R, reps: int = fs.REPS) -> list:
    """The four variants' rows, printed and returned."""
    c = fs.make_case(device, n, batches)

    def fn_of(banks, deferred):
        def fn(q):
            vals, idx = fused_score_topk_int4_rerank(c.db4, c.scales, c.db8, q, 64, count=n,
                                                     rerank=128, banks=banks,
                                                     deferred=deferred)
            return _exact_flat_rerank(c.db8, c.scales, q, vals, idx, fs.K, rbuf=c.rq8,
                                      rbuf_scales=c.rsc2)
        return fn

    rows = [fs.timed_row(c, name, fn_of(banks, deferred), reps=reps)
            for name, banks, deferred in VARIANTS]
    print(json.dumps({"sweep": rows}), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(fs.cli(main, "int4_bank_sweep"))
