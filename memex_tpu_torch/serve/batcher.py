"""Search microbatcher for the port (port of memex_tpu/serve/batcher.py).

memex_tpu's SearchBatcher and Microbatcher are reused; this subclass only
replaces the two methods that import memex_tpu's JAX query path
(`_dispatch` and `warmup`) with the port's FusedQueryPath.
"""

from __future__ import annotations

import numpy as np

from memex_tpu.log import get_logger
from memex_tpu.serve.batcher import SearchBatcher as _SearchBatcher
from memex_tpu.store.base import SearchHit

from .query_path import _Q_BUCKETS, FusedQueryPath, _bucket

logger = get_logger(__name__)


class SearchBatcher(_SearchBatcher):
    """Batches (collection, query_text, limit) requests: one encode and one
    fused scan per collection per batch, dispatched pipelined."""

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
                    vectors = self.rt.engine.encode_batch([q for (_, q, _) in items])
                # Pad Q to its bucket, as the fused path does; zero pad rows
                # are sliced off.
                qv = np.zeros((_bucket(len(idxs), _Q_BUCKETS), vectors.shape[1]), np.float32)
                qv[: len(idxs)] = [vectors[i] for i in idxs]
                batch_hits = store.search_batch(qv, max_limit)
                for j, i in enumerate(idxs):
                    results[i] = batch_hits[j][: items[i][2]]
            return results

        return finish
