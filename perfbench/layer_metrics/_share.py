"""Helpers the readers share (not a metric: no BENCHMARK.json entry names it)."""

from __future__ import annotations


def fill(obs: dict) -> float | None:
    c = obs.get("counters") or {}
    batches = c.get("batcher.search.batches", 0)
    return c.get("batcher.search.items", 0) / batches if batches else None


def dispatch_ms(obs: dict) -> float | None:
    c = obs.get("counters") or {}
    batches = c.get("batcher.search.batches", 0)
    return c.get("batcher.search.dispatch_us", 0) / 1e3 / batches if batches else None


def idle(obs: dict) -> float | None:
    tr = obs.get("trace")
    if not tr or not tr.get("kernels") or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]

