"""The recall/QPS harness on the card: `bench_tier` on cuda builds the flat
tiers there and searches them through their CUDA kernels (K1 for float32
rows, K2 for int8 rows and queries), with the recall of the same scan run
on the CPU. Marked `gpu`: without a CUDA card every test here skips. Run on
a card with

    python -m pytest --noconftest -m gpu tests/test_torch_benchmarks_gpu.py

The CPU reference is a FlatIndex with `use_fused=True`, which runs each
kernel's plain version: `bench_tier(device="cpu")` takes the unfused scan
instead, which scores int8 rows against bf16 queries where K2 quantizes the
queries to int8 (memex_tpu's CPU and TPU paths differ alike), so its int8
recall is another number. K2 is bit-equal to its plain version and K1 sums
the same bf16 products in another order, so on this corpus both give the
reference's hits: recall is compared exactly.
"""

import numpy as np
import pytest
import torch

from memex_tpu_torch.benchmarks.datasets import make_corpus, make_queries, oracle_topk
from memex_tpu_torch.benchmarks.run import bench_tier
from memex_tpu_torch.index import FlatIndex
from memex_tpu_torch.ops import fused_topk as ft

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("tier, dtype, kernel", [("flat", "float32", "fused_topk"),
                                                 ("flat_int8", "int8", "fused_topk_int8q")])
def test_bench_tier_on_the_card_runs_its_kernel_with_the_cpu_recall(cuda, tier, dtype, kernel):
    corpus = make_corpus(20_000, 384)
    queries = make_queries(corpus, 32)
    ids = [f"v{i}" for i in range(corpus.shape[0])]
    ref = FlatIndex(384, capacity=len(ids) + 1, dtype=dtype, use_fused=True, device="cpu")
    ref.add(corpus, ids)
    expect = oracle_topk(corpus, queries, 10)
    hits = ref.search(queries, 10)
    cpu_recall = round(float(np.mean([len({s for s, _ in h} & {f"v{j}" for j in e}) / 10
                                      for h, e in zip(hits, expect)])), 4)
    ft.reset_launches()
    card = bench_tier(tier, corpus, queries, k=10, repeats=2, device=cuda)
    # One launch a search: the recall pass and the two timed ones.
    assert ft.LAUNCHES[kernel] == 3, ft.LAUNCHES
    assert card["recall_at_k"] == cpu_recall, (card, cpu_recall)
    assert card["qps"] > 0
