"""The benchmark entry point's stages on the card: bench_kernels at 1M rows
launches each tier's kernel once a search (K1-K4, read from
ops/fused_topk's launch counters) and reads, on every tier, the recall
that the kernels' plain versions give on the same rows, and every query of
its batches above Q agrees with the plain versions; bench_scale_10m at
a small size runs K2, K5 and K6. Marked `gpu`: without a CUDA card every
test here skips. Run on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_bench_gpu.py

The plain recall is the same tier functions over a CPU copy of the rows,
where each wrapper runs its kernel's plain version. K2 and K4 are
bit-equal to their plain versions and K1 and K3 sum the same products in
another order; on random unit rows no top-10 boundary sits that close, so
recall is compared exactly.
"""

import pytest
import torch

from memex_tpu_torch import bench
from memex_tpu_torch.ops import fused_topk as ft
from memex_tpu_torch.ops.topk import score_topk

pytestmark = pytest.mark.gpu

KERNEL_OF = {
    "f32": "fused_topk", "bf16": "fused_topk", "int8": "fused_topk_int8",
    "int8q": "fused_topk_int8q", "int8q_refine": "fused_topk_int8q",
    "int8q_q128": "fused_topk_int8q", "int8q_q256": "fused_topk_int8q",
    "int8q_q512": "fused_topk_int8q", "int4": "fused_topk_int4q",
    "int4_refine": "fused_topk_int4q", "int4_q128": "fused_topk_int4q",
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_bench_kernels_launches_once_a_search_with_the_plain_recall(cuda):
    chain, chain_big, reps = 4, 3, 2
    ft.reset_launches()
    res = bench.bench_kernels(cuda, chain=chain, chain_big=chain_big, reps=reps)
    launches = dict(ft.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    for name, row in res.items():
        # The warm call, reps chains, and the recall search.
        expect[KERNEL_OF[name]] += 2 + reps * (chain if row["query_batch"] <= bench.Q
                                               else chain_big)
    assert launches == expect

    db = bench.kernel_rows(cuda)
    oracle_q = bench._randn(2, (bench.Q, bench.D), cuda)
    oracle = score_topk(db, oracle_q, bench.K, method="exact_f32")[1].cpu().numpy()
    for name, _, fn in bench.kernel_tiers(db.cpu()):
        plain = bench.kernel_recall(fn, oracle_q.cpu(), oracle)
        assert res[name]["recall_at_10"] == plain, (name, res[name], plain)
        assert res[name]["roofline"]["bound"] in ("hbm", "compute")


def test_bench_kernels_big_batches_agree_with_the_plain_versions_on_every_query(cuda):
    """The tiers above Q queries run K2 and K4 on more than one 128-query
    tile, and bench_kernels reads recall on the first Q only: here every
    query of the first batch bench_kernels times is held to the plain
    version. K2's tiers are bit-equal to fused_score_topk_int8q_reference
    on the same card tensors; K4's rerank sums float32 products in another
    order, so its tier is held to the plain version's recall against the
    exact oracle of all the batch's queries."""
    db = bench.kernel_rows(cuda)
    db8, scales, _, _ = ft.quantize_rows_int8_refine(db)
    oracle_q = bench._randn(2, (bench.Q, bench.D), cuda)
    plain_tiers = {name: fn for name, _, fn in bench.kernel_tiers(db.cpu())}
    for name, qb, fn in bench.kernel_tiers(db):
        if qb <= bench.Q:
            continue
        q = bench._randn(2, (qb, bench.D), cuda)
        q[: bench.Q] = oracle_q  # bench_kernels' first batch
        if KERNEL_OF[name] == "fused_topk_int8q":
            kv, ki = fn(q)
            pv, pi = ft.fused_score_topk_int8q_reference(db8, scales, q, bench.K,
                                                         count=db.shape[0], banks=4)
            assert torch.equal(kv, pv) and torch.equal(ki, pi), name
            continue
        oracle = score_topk(db, q, bench.K, method="exact_f32")[1].cpu().numpy()
        assert (bench.kernel_recall(fn, q, oracle)
                == bench.kernel_recall(plain_tiers[name], q.cpu(), oracle)), name


def test_scale_10m_small_runs_k2_k5_k6(cuda):
    ft.reset_launches()
    out = bench.bench_scale_10m(cuda, n10=1 << 18, blk=1 << 16, centers=512, n_clusters=64,
                                nprobe=8, batches=2, reps=1, n_extra=256)
    for name in ("fused_topk_int8q", "ivf_batch", "ivf_batch4"):
        assert ft.LAUNCHES[name] > 0, ft.LAUNCHES
    assert out["ivf_recall_at_10_vs_exact_f32"] >= 0.9, out
    assert out["ivf_roofline_q32"]["pct_peak_hbm"] > 0
