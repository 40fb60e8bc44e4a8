"""Recall/QPS harness CLI (port of memex_tpu/benchmarks/run.py).

Usage:
  python -m memex_tpu_torch.benchmarks.run --n 100000 --tiers flat,flat_bf16,ivf,hnsw
  python -m memex_tpu_torch.benchmarks.run --n 1000000 --tiers flat_int8 --q 32 --k 10
  python -m memex_tpu_torch.benchmarks.run --n 3000 --device cpu

Prints one JSON object per tier: recall@k vs the exact oracle, search
latency/QPS, and ingest/build time. The flat and IVF tiers live on
`--device` (default cuda); without a card the command fails unless it is
given `--device cpu`: it never moves to the CPU on its own. The HNSW tier is
the native library's, on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..runtime import require_device
from .datasets import make_corpus, make_queries, oracle_topk


def bench_tier(tier: str, corpus, queries, k: int, repeats: int = 16,
               n_clusters: int | None = None, nprobe: int | None = None, *,
               device="cuda") -> dict:
    """Build `tier` over `corpus` (on `device`; HNSW on the host), score its
    top-k for `queries` against the exact oracle, then time `repeats`
    sequential searches by the host clock. Every device search ends in a
    copy back to the host that waits for the device, so the clock covers
    the device's work; the recall pass before it is the warmup (it also
    covers a kernel's first-use build)."""
    n, dim = corpus.shape
    ids = [f"v{i}" for i in range(n)]
    t_build0 = time.perf_counter()
    if tier.startswith("flat"):
        from ..index import FlatIndex

        dtype = {"flat": "float32", "flat_bf16": "bfloat16", "flat_int8": "int8"}[tier]
        index = FlatIndex(dim=dim, capacity=n + 1, dtype=dtype, device=device)
        index.add(corpus, ids)
        search = lambda q, kk: index.search(q, kk)  # noqa: E731
    elif tier.startswith("ivf"):
        from ..index import IVFIndex

        dtype = {"ivf": "float32", "ivf_bf16": "bfloat16", "ivf_int8": "int8"}[tier]
        C = n_clusters or max(16, int(np.sqrt(n)))
        index = IVFIndex(dim=dim, n_clusters=C, nprobe=nprobe or max(1, C // 8),
                         dtype=dtype, device=device)
        index.build(corpus, ids)
        search = lambda q, kk: index.search(q, kk)  # noqa: E731
    elif tier == "hnsw":
        from ..store.base import VectorData
        from ..store.hnsw_store import HnswStore

        store = HnswStore(None, "bench", dim=dim)
        store.add_vectors(
            [VectorData(id=ids[i], document_id="d", text="", vector=corpus[i]) for i in range(n)]
        )
        search = lambda q, kk: [  # noqa: E731
            [(h.id, h.score) for h in hits] for hits in store.search_batch(q, kk)
        ]
    else:
        raise ValueError(f"unknown tier {tier!r}")
    build_s = time.perf_counter() - t_build0

    expect = oracle_topk(corpus, queries, k, device=device)
    results = search(queries, k)
    recalls = [
        len({s for s, _ in results[i]} & {f"v{j}" for j in expect[i]}) / k
        for i in range(queries.shape[0])
    ]

    t0 = time.perf_counter()
    for _ in range(repeats):
        search(queries, k)
    per_batch = (time.perf_counter() - t0) / repeats
    return {
        "tier": tier,
        "n": n,
        "dim": dim,
        "k": k,
        "q": int(queries.shape[0]),
        "recall_at_k": round(float(np.mean(recalls)), 4),
        "build_s": round(build_s, 3),
        "search_batch_ms": round(per_batch * 1e3, 3),
        "qps": round(queries.shape[0] / per_batch, 1),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--dim", type=int, default=384)
    parser.add_argument("--q", type=int, default=32)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--kind", default="clustered", choices=["clustered", "uniform"])
    parser.add_argument("--tiers", default="flat,flat_bf16,flat_int8,ivf,hnsw")
    parser.add_argument("--repeats", type=int, default=16)
    parser.add_argument("--clusters", type=int, default=None, help="IVF n_clusters")
    parser.add_argument("--nprobe", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the flat and IVF tiers (default cuda)")
    args = parser.parse_args(argv)
    device = require_device(args.device, "benchmarks.run")
    if device is None:
        return 2

    corpus = make_corpus(args.n, args.dim, kind=args.kind)
    queries = make_queries(corpus, args.q)
    for tier in args.tiers.split(","):
        tier = tier.strip()
        if not tier:
            continue
        print(json.dumps(bench_tier(tier, corpus, queries, args.k, args.repeats,
                                    n_clusters=args.clusters, nprobe=args.nprobe,
                                    device=device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
