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

import numpy as np
import torch

from memex_tpu.log import get_logger

from ..embed.engine import seq_bucket
from ..index.flat import (
    FlatIndex,
    _exact_flat_rerank,
    _int4_deferred,
    _int4_rerank_depth,
    _search_masked_fused,
    _search_masked_fused_int4,
    _search_masked_fused_int8,
    _search_plain,
    _search_rerank_fused,
)

logger = get_logger(__name__)

_Q_BUCKETS = (1, 8, 32, 64, 128, 256)
_K_BUCKETS = (16, 128)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _encode_and_search(engine, ids: np.ndarray, mask: np.ndarray, index: FlatIndex,
                       count: int, mean, *, k: int, k_ret: int, use_fused: bool,
                       block_n: int, exact: bool):
    """Encoder forward + the branch structure of FlatIndex.search, on the
    device. As memex_tpu's serve path does, this always passes
    `index.alive` into the scan, keeps the scan's default 128-wide
    candidate list (kk) on the non-rerank branches, and picks int4's
    unpack from the bucketed batch size (deferred for B <= 64);
    FlatIndex.search passes alive only when rows are dead."""
    queries = engine.encode_ids(ids, mask)  # unit vectors on the device
    B = ids.shape[0]
    dtype = index.dtype
    kk = min(max(4 * k, k_ret), 128)
    with torch.inference_mode():
        if use_fused and k_ret > k:
            if dtype == "int4":
                kk_arg, deferred = _int4_rerank_depth(k_ret), _int4_deferred(B)
            else:
                kk_arg, deferred = kk, False
            vals, rows = _search_rerank_fused(
                index.buf, index.scales, index.buf8, index.rbuf, index.rbuf_scales,
                index.alive, count, queries, k, k_ret, kk_arg, block_n,
                index.query_quantize, deferred, dtype, exact)
        elif use_fused and dtype == "int4":
            vals, rows = _search_masked_fused_int4(
                index.buf, index.scales, index.buf8, index.alive, count, queries, k,
                block_n=block_n, rerank=_int4_rerank_depth(k), deferred=_int4_deferred(B))
        elif use_fused and dtype == "int8":
            vals, rows = _search_masked_fused_int8(
                index.buf, index.scales, index.alive, count, queries, k, block_n=block_n,
                qquant=index.query_quantize)
        elif use_fused:
            vals, rows = _search_masked_fused(index.buf, index.alive, count, queries, k,
                                              exact=exact, keep2=exact)
        else:
            # Plain path: int4 scores from its int8 copy; the rerank runs as
            # a second stage, like FlatIndex.search's.
            src = index.buf8 if dtype == "int4" else index.buf
            vals, rows = _search_plain(src, index.scales, index.alive, count, queries, k_ret,
                                       exact=exact)
            if k_ret > k:
                vals, rows = _exact_flat_rerank(src, index.scales, queries, vals, rows, k,
                                                rbuf=index.rbuf,
                                                rbuf_scales=index.rbuf_scales)
        if mean is not None:
            # Centred storage: restore true cosines with the query-constant
            # q . mean (rank-safe after the rerank too).
            vals = vals + (queries @ mean)[:, None]
    return vals, rows


@dataclass
class _Dispatched:
    """An in-flight fused query batch: device work is queued, the winners
    are not copied back yet. `finish()` copies and hydrates."""

    parts: list  # [(vals_dev, rows_dev, ids_snapshot, count, n_texts, k)]

    def finish(self) -> list:
        out = []
        for vals_d, rows_d, ids_snapshot, count, n_texts, k in self.parts:
            vals, rows = vals_d.cpu().numpy(), rows_d.cpu().numpy()
            for qi in range(n_texts):
                hits = []
                for v, r in zip(vals[qi], rows[qi]):
                    if v <= -1e29 or r >= count:
                        continue
                    hits.append((ids_snapshot[r], float(v)))
                out.append(hits[:k])
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
        encoded = [tok.encode(t, add_special_tokens=True)[: self.engine.max_seq_length]
                   for t in texts]
        L = seq_bucket(max(len(e) for e in encoded), self.engine.max_seq_length)
        B = _bucket(len(texts), _Q_BUCKETS)
        ids = np.full((B, L), tok.pad_id, np.int32)
        mask = np.zeros((B, L), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        mask[len(texts):, 0] = 1  # pad rows: avoid 0/0 pooling

        # The lock is held through the launch: a concurrent add() writes
        # rows in place or swaps a grown buffer, and a compact() renumbers
        # rows under the id mapping. Every launch and copy goes to the one
        # current stream, so once queued the work reads a consistent index;
        # the blocking copy back happens unlocked in finish().
        with store._lock:
            count = index.count
            ids_snapshot = index.ids  # replaced (not mutated) by compaction
            vals, rows = self._dispatch_device(index, ids, mask, k, count)
        return _Dispatched([(vals, rows, ids_snapshot, count, len(texts), k)])

    def _dispatch_device(self, index: FlatIndex, ids, mask, k: int, count: int):
        """The device call itself; the caller holds the store lock. Mirrors
        FlatIndex.search's operating-point math (k_ret, use_fused)."""
        k_eff = min(_bucket(k, _K_BUCKETS), count)
        rer = index.rerank or 0
        k_ret = min(max(k_eff, rer), count) if rer else k_eff
        return _encode_and_search(
            self.engine, ids, mask, index, count, _mean_dev(index), k=k_eff,
            k_ret=k_ret, use_fused=index.use_fused and k_ret <= 128,
            block_n=index.scan_block_n(), exact=index.scan_precision == "highest")

    def warmup(self, store, k: int = 10, seq_lens: tuple[int, ...] = (32,),
               q_buckets: tuple[int, ...] | None = None) -> int:
        """Run every (Q bucket, seq bucket) shape this store can see once
        before traffic (first-use costs: the kernel build, allocator
        growth). Returns the number of shapes run."""
        if not self.supports(store):
            return 0
        index: FlatIndex = store.index
        tok = self.engine.tokenizer
        count = index.count
        n = 0
        for L in seq_lens:
            for B in (q_buckets or _Q_BUCKETS):
                ids = np.full((B, L), tok.pad_id, np.int32)
                mask = np.zeros((B, L), np.int32)
                mask[:, 0] = 1
                with store._lock:
                    self._dispatch_device(index, ids, mask, k, count)
                n += 1
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        logger.info("fused query path warm: %d shapes", n)
        return n


def _mean_dev(index: FlatIndex):
    """Device copy of the centring mean, cached per pinned mean."""
    mean = index.mean
    if mean is None or not mean.any():
        return None
    cached = getattr(index, "_mean_dev_cache", None)
    if cached is not None and cached[0] is mean:
        return cached[1]
    dev = torch.from_numpy(mean).to(index.device)
    index._mean_dev_cache = (mean, dev)
    return dev

