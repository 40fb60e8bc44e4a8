"""Fused query path: encoder forward + index scan on the device, one fetch.

Port of memex_tpu/serve/query_path.py. The query vectors never leave the
device: the batch is encoded, scanned (the fused CUDA kernel on the card),
optionally reranked, and shifted by `q . mean`, and only the [Q, k]
winners are copied back. Queries pad to a Q bucket and a sequence bucket
and k rounds up to a k bucket, so the set of shapes stays small (the
buckets a later CUDA-graph capture will cover).

`dispatch()` queues the device work under the store lock and returns;
`_Dispatched.finish()` copies the winners back and hydrates ids outside
the lock, so the batcher can queue batch N+1 while batch N is copied.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..log import get_logger

from ..embed.engine import pad_rows, seq_bucket
from ..index.flat import FlatIndex, hits_from
from ..metrics import METRICS
from ..ops.host import fetch

logger = get_logger(__name__)

_Q_BUCKETS = (1, 8, 32, 64, 128, 256)
_K_BUCKETS = (16, 128)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class _Dispatched:
    """An in-flight fused query batch: device work is queued, the winners
    are not copied back yet. `finish()` copies and hydrates."""

    parts: list  # [(vals_dev, rows_dev, ids_snapshot, count, n_texts, k)]

    def finish(self) -> list:
        out = []
        for vals_d, rows_d, ids_snapshot, count, n_texts, k in self.parts:
            with METRICS.span("query.fetch"):
                vals, rows = fetch(vals_d, rows_d)  # one wait for the pair
            hits = hits_from(vals[:n_texts], rows[:n_texts], ids_snapshot, count)
            out.extend(h[:k] for h in hits)
        return out


class FusedQueryPath:
    """Glues an EmbeddingEngine to the port's flat-store collections."""

    def __init__(self, engine):
        self.engine = engine

    def supports(self, store) -> bool:
        index = getattr(store, "index", None)
        return type(index) is FlatIndex and index.count > 0

    def dispatch(self, store, texts: list[str], k: int) -> _Dispatched:
        """Queue the encode+scan for `texts`; `.finish()` fetches."""
        cap = _Q_BUCKETS[-1]
        parts = []
        for s in range(0, len(texts), cap):
            parts.extend(self._dispatch_slice(store, texts[s : s + cap], k).parts)
        return _Dispatched(parts)

    def search_texts(self, store, texts: list[str], k: int):
        """texts -> per-text [(id, score)]."""
        return self.dispatch(store, texts, k).finish()

    def _dispatch_slice(self, store, texts: list[str], k: int) -> _Dispatched:
        index: FlatIndex = store.index
        tok = self.engine.tokenizer
        with METRICS.span("query.tokenize"):
            encoded = [tok.encode(t, add_special_tokens=True)[: self.engine.max_seq_length]
                       for t in texts]
            L = seq_bucket(max(len(e) for e in encoded), self.engine.max_seq_length)
            ids, mask = pad_rows(encoded, L, tok.pad_id, _bucket(len(texts), _Q_BUCKETS))

        # The lock is held through the launch: a concurrent add() writes
        # rows in place or swaps a grown buffer, and a compact() renumbers
        # rows under the id mapping. Every launch and copy goes to the one
        # current stream, so once queued the work reads a consistent index;
        # the blocking copy back happens unlocked in finish().
        with METRICS.span("query.lock_wait"):
            store._lock.acquire()
        try:
            with METRICS.span("query.launch"):
                count = index.count
                ids_snapshot = index.ids  # replaced (not mutated) by compaction
                vals, rows = self._dispatch_device(index, ids, mask, k)
        finally:
            store._lock.release()
        return _Dispatched([(vals, rows, ids_snapshot, count, len(texts), k)])

    def _dispatch_device(self, index: FlatIndex, ids, mask, k: int):
        """Encoder forward, the index's scan at the bucketed k, and the
        q . mean restore, all on the device; the caller holds the store
        lock. As memex_tpu's serve path does, alive always rides into the
        scan, and a scan without rerank keeps the bank's full 128-wide
        candidate list."""
        mean = index.device_mean()
        queries = self.engine.encode_ids(ids, mask)  # unit vectors on the device
        with torch.inference_mode():
            vals, rows = index.scan(queries, _bucket(k, _K_BUCKETS), mask_alive=True,
                                    candidates=128)
            if mean is not None:
                # Centred storage: restore true cosines with the
                # query-constant q . mean (rank-safe after the rerank too).
                vals = vals + (queries @ mean)[:, None]
        return vals, rows

    def warmup(self, store, k: int = 10, seq_lens: tuple[int, ...] = (32,),
               q_buckets: tuple[int, ...] | None = None) -> int:
        """Run every (Q bucket, seq bucket) shape this store can see once
        before traffic (first-use costs: the kernel build, allocator
        growth). Returns the number of shapes run."""
        if not self.supports(store):
            return 0
        index: FlatIndex = store.index
        pad_id = self.engine.tokenizer.pad_id
        n = 0
        for L in seq_lens:
            for B in (q_buckets or _Q_BUCKETS):
                ids, mask = pad_rows([], L, pad_id, B)
                with store._lock:
                    self._dispatch_device(index, ids, mask, k)
                n += 1
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        logger.info("fused query path warm: %d shapes", n)
        return n

