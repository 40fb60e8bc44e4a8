"""The keep2 slot fold at 1M x 384 (memex_tpu's benchmarks/keep2_validate.py
on CUDA cards): the refine tiers through `_search_rerank_fused` with the
fold keeping one or two rows a slot. int8q_refine scans with K2 (S = 512);
int4_refine with K4 (deferred unpack, S = 1024 and 2048). The script's
expectation: the few oracle rows the refine tiers lose are two-winner slot
collisions, so keep2 recovers them at a small cost in fold time.

    python -m memex_tpu_torch.benchmarks.keep2_validate [--device cuda|cpu]

Prints one JSON row a variant: variant, qps, p50_batch_ms, recall_at_10,
compile_s (flat_sweep.py says how they are measured).
"""

from __future__ import annotations

import sys

from ..index.flat import _search_rerank_fused
from . import flat_sweep as fs


def main(device="cuda", n: int = fs.N, *, batches: int = fs.R, reps: int = fs.REPS) -> list:
    """The keep2 validation rows, printed and returned."""
    c = fs.make_case(device, n, batches)

    def i8(keep2):
        return lambda q: _search_rerank_fused(
            c.db8, c.scales, None, c.rq8, c.rsc2, None, n, q, fs.K, 64, 64, 8192,
            True, False, "int8", False, 16, keep2)

    def i4(banks4, keep2):
        return lambda q: _search_rerank_fused(
            c.db4, c.scales, c.db8, c.rq8, c.rsc2, None, n, q, fs.K, 64, 128, 32768,
            True, True, "int4", False, banks4, keep2)

    return [fs.timed_row(c, name, fn, reps=reps) for name, fn in (
        ("int8q_refine_keep1", i8(False)),       # memex_tpu's round-4 baseline
        ("int8q_refine_keep2", i8(True)),
        ("int4_refine_b8_keep1", i4(8, False)),  # memex_tpu's round-4 baseline
        ("int4_refine_b16_keep1", i4(16, False)),
        ("int4_refine_b16_keep2", i4(16, True)),
        ("int4_refine_b8_keep2", i4(8, True)),
    )]


if __name__ == "__main__":
    sys.exit(fs.cli(main, "keep2_validate"))
