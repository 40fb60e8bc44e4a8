"""Recall and QPS harness (port of memex_tpu/benchmarks).

Reproducible measurements behind `python -m memex_tpu_torch.benchmarks.run`:
  - recall@k of the flat (float32, bfloat16, int8) and IVF tiers and of
    the native HNSW against the exact float32 oracle, on seeded synthetic
    corpora (datasets.py, bit-equal to memex_tpu's);
  - search QPS and build time on the device asked for (`--device`,
    default cuda; no command moves to the CPU on its own);
  - recall against the reference's HNSW parameters (hnsw_recall.py), and
    the local LLM's decode throughput (llm_bench.py).

The reference publishes no numbers; this harness keeps the port's claims
comparable with memex_tpu's on the same corpora.
"""
