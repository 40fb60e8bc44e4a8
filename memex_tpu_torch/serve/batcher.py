"""Request microbatching with a dispatch/complete pipeline.

One encode+scan over Q queries costs little more than over one: on the
H100 a search batch's cost is the host's launch of its ~200 kernels
(6.7-11 ms for 1.4-1.5 queries; PERF.md section 5). The batcher collects
concurrent requests for up to `max_wait_ms` (or until `max_batch`) and
executes them as one device call; queries to the same collection share a
single fused-kernel scan.

Pipelining: `run_batch_async` splits a batch into a dispatch, which
queues the device work and returns, and a `finish`, which waits for the
winners' copy and builds the results on a completer thread. The
collecting thread launches batch N+1 while batch N is copied back
(device execution is in-order, so results stay correct; per-client
ordering holds because each client blocks on its own future). In-flight
batches are semaphore-bounded so a slow device backpressures collection
instead of queueing unbounded.

Latency math: +max_wait_ms p50 cost buys ~Qx throughput under load; with
no concurrency the queue drains immediately after one wait window.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..log import get_logger
from ..metrics import METRICS, profile_trace
from ..store.base import SearchHit
from .query_path import _Q_BUCKETS, FusedQueryPath, _bucket

logger = get_logger(__name__)

# Pipelined batches in flight, and the threads that complete them.
# Completion is short on the card (the winners' copy, query.fetch, reads
# 0.24-0.3 ms a batch; PERF.md section 5), so two threads keep up.
_PIPELINE_DEPTH = 3
_COMPLETER_THREADS = 2


@dataclass
class _Pending:
    item: Any
    future: Future = field(default_factory=Future)
    t: float = field(default_factory=time.perf_counter)  # when submitted


class Microbatcher:
    """Generic batcher: batches collected within the wait window are run
    either synchronously (`run_batch(items) -> results`) or pipelined
    (`run_batch_async(items) -> finish`, where `finish() -> results` is
    executed in order on a completer thread)."""

    def __init__(self, run_batch: Callable[[list], list] | None = None,
                 max_batch: int = 32, max_wait_ms: float = 3.0,
                 name: str = "batch",
                 run_batch_async: Callable[[list], Callable[[], list]] | None = None):
        assert (run_batch is None) != (run_batch_async is None), \
            "exactly one of run_batch / run_batch_async"
        self.run_batch = run_batch
        self.run_batch_async = run_batch_async
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.name = name
        self._pending: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._shutdown = False
        self._pool = None
        self._sem: threading.Semaphore | None = None
        if run_batch_async is not None:
            from concurrent.futures import ThreadPoolExecutor

            self._sem = threading.Semaphore(_PIPELINE_DEPTH)
            self._pool = ThreadPoolExecutor(
                max_workers=_COMPLETER_THREADS,
                thread_name_prefix=f"memex-{name}-complete")
        self._thread = threading.Thread(target=self._loop, name=f"memex-{name}", daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        p = _Pending(item)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("batcher is shut down")
            self._pending.append(p)
            self._wake.notify()
        return p.future

    def __call__(self, item: Any, timeout: float = 120.0):
        return self.submit(item).result(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            self._shutdown = True
            self._wake.notify()
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def _collect(self) -> list[_Pending] | None:
        """Wait for work; returns a batch, or None on shutdown-and-drained."""
        with self._lock:
            while not self._pending and not self._shutdown:
                self._wake.wait()
            if self._shutdown and not self._pending:
                return None
            # Collect until the window closes or the batch fills. A
            # single wait() would end on the FIRST notify (one more
            # submit), degenerating steady-load batches to ~2 items;
            # and when a backlog is already >= max_batch there is
            # nothing to wait for at all.
            deadline = time.monotonic() + self.max_wait
            while (len(self._pending) < self.max_batch
                   and not self._shutdown):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wake.wait(remaining)
            batch = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch :]
        now = time.perf_counter()
        METRICS.add_span(f"batcher.{self.name}.queue_wait", sum(now - p.t for p in batch),
                         len(batch))
        return batch

    def _loop(self) -> None:
        while True:
            with METRICS.span(f"batcher.{self.name}.collect"):
                batch = self._collect()
            if batch is None:
                return
            profile_trace()
            METRICS.inc(f"batcher.{self.name}.batches")
            METRICS.inc(f"batcher.{self.name}.items", len(batch))
            if self.run_batch_async is not None:
                self._sem.acquire()  # blocks at the pipeline-depth limit
                try:
                    with METRICS.span(f"batcher.{self.name}.dispatch"):
                        finish = self.run_batch_async([p.item for p in batch])
                except Exception as exc:
                    self._sem.release()
                    logger.exception("batch %s dispatch failed", self.name)
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(exc)
                    continue
                self._pool.submit(self._complete_one, batch, finish)
                continue
            try:
                with METRICS.span(f"batcher.{self.name}.run"):
                    results = self.run_batch([p.item for p in batch])
                self._resolve(batch, results)
            except Exception as exc:
                logger.exception("batch %s failed", self.name)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _complete_one(self, batch: list[_Pending], finish) -> None:
        try:
            with METRICS.span(f"batcher.{self.name}.complete"):
                results = finish()
            self._resolve(batch, results)
        except Exception as exc:
            logger.exception("batch %s completion failed", self.name)
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(exc)
        finally:
            self._sem.release()

    def _resolve(self, batch: list[_Pending], results: list) -> None:
        if len(results) != len(batch):
            raise RuntimeError(
                f"run_batch returned {len(results)} results for {len(batch)} items"
            )
        for p, r in zip(batch, results):
            p.future.set_result(r)


class SearchBatcher:
    """Batches (collection, query_text, limit) search requests: one encoder
    call for all queries in the window, one fused scan per collection,
    dispatched pipelined (see Microbatcher)."""

    def __init__(self, runtime, max_batch: int = 32, max_wait_ms: float = 3.0):
        self.rt = runtime
        self._fused = None
        self._mb = Microbatcher(
            run_batch_async=self._dispatch, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="search",
        )

    def search(self, collection: str, query: str, limit: int, timeout: float = 120.0):
        return self._mb((collection, query, limit), timeout=timeout)

    def close(self) -> None:
        self._mb.close()

    def _fused_path(self) -> FusedQueryPath:
        if self._fused is None:
            self._fused = FusedQueryPath(self.rt.engine)
        return self._fused

    def warmup(self, collection: str, k: int = 10,
               seq_lens: tuple[int, ...] = (32,)) -> int:
        """Run every Q bucket up to the one covering max_batch once: the
        fused path for flat stores, search_batch for the other device
        stores (IVF). Returns the batch shapes run."""
        store = self.rt.store(collection)
        fused = self._fused_path()
        top = _bucket(self._mb.max_batch, _Q_BUCKETS)
        buckets = tuple(b for b in _Q_BUCKETS if b <= top)
        if fused.supports(store):
            return fused.warmup(store, k=k, seq_lens=seq_lens, q_buckets=buckets)
        # Other stores of the port (IVF) warm through the search_batch path
        # the dispatch loop uses, at every Q bucket. HNSW and remote stores
        # have no index on the device (and a remote warmup would send real
        # traffic).
        index = getattr(store, "index", None)
        if index is None or getattr(index, "count", 0) == 0:
            return 0
        dim = getattr(store, "dim", None) or index.dim
        for B in buckets:
            store.search_batch(np.zeros((B, dim), np.float32), k)
        logger.info("non-fused store warm: %d batch shapes", len(buckets))
        return len(buckets)

    def _dispatch(self, items: list[tuple[str, str, int]]):
        """Stage 1: group by collection and queue the device work. Returns
        the stage-2 closure that fetches winners and hydrates ids."""
        fused = self._fused_path()
        by_col: dict[str, list[int]] = {}
        for i, (col, _, _) in enumerate(items):
            by_col.setdefault(col, []).append(i)
        fused_parts = []   # (idxs, store, dispatched)
        direct_parts = []  # (idxs, store, max_limit): non-fused, run in finish
        for col, idxs in by_col.items():
            store = self.rt.store(col)
            max_limit = max(items[i][2] for i in idxs)
            if fused.supports(store):
                disp = fused.dispatch(store, [items[i][1] for i in idxs], max_limit)
                fused_parts.append((idxs, store, disp))
            else:
                direct_parts.append((idxs, store, max_limit))

        def finish() -> list:
            results: list = [None] * len(items)
            for idxs, store, disp in fused_parts:
                raw = disp.finish()
                doc_of = getattr(store, "_doc_of", {})
                for j, i in enumerate(idxs):
                    results[i] = [SearchHit(id=sid, score=s, document_id=doc_of.get(sid))
                                  for sid, s in raw[j]][: items[i][2]]
            vectors = None
            for idxs, store, max_limit in direct_parts:
                if vectors is None:
                    with METRICS.span("search.direct.encode"):
                        vectors = self.rt.engine.encode_batch([q for (_, q, _) in items])
                # Pad Q to its bucket, as the fused path does; zero pad rows
                # are sliced off.
                qv = np.zeros((_bucket(len(idxs), _Q_BUCKETS), vectors.shape[1]), np.float32)
                qv[: len(idxs)] = [vectors[i] for i in idxs]
                with METRICS.span("search.direct.search"):
                    batch_hits = store.search_batch(qv, max_limit)
                for j, i in enumerate(idxs):
                    results[i] = batch_hits[j][: items[i][2]]
            return results

        return finish
