"""Vector stores of the port (port of memex_tpu/store/tpu_store.py's
TpuFlatStore and MemoryStore).

One store per collection. The flat store's index stays resident on its
device for the process lifetime; `checkpoint()` persists it to the
collection's directory in memex_tpu's format, and construction restores
from that checkpoint when present.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from memex_tpu.log import get_logger
from memex_tpu.native_lib import np_normalize_rows
from memex_tpu.store.base import SearchHit, VectorData

from ..index.flat import FlatIndex

logger = get_logger(__name__)


def _normalize(vectors: np.ndarray) -> np.ndarray:
    return np_normalize_rows(np.atleast_2d(np.asarray(vectors, np.float32)))


class TpuFlatStore:
    """Flat exact store (the default `tpu://` tier), on `device`. The class
    keeps memex_tpu's name: the scheme and the on-disk layout are the same."""

    # Maintenance scheduling: when the runtime wires `on_maintenance`,
    # O(corpus) work (IVF retrains) is enqueued as a worker Maintain task
    # instead of running inline on whichever request tripped the trigger.
    # Class attributes, so every store subclass inherits them.
    on_maintenance = None        # callable(collection, reason) | None
    _maintenance_last = 0.0      # time-windowed dedup, not a latch: a failed
    #                              Maintain task must not suppress scheduling

    def request_maintenance(self, reason: str) -> bool:
        """Schedule background maintenance; True if scheduled (or requested
        in the last 5 s: the queue dedups pending tasks too). False: no
        scheduler is wired, and the caller does the work inline."""
        cb = self.on_maintenance
        if cb is None:
            return False
        now = time.monotonic()
        if now - self._maintenance_last < 5.0:
            return True
        self._maintenance_last = now
        try:
            cb(self.collection, reason)
        except Exception:
            logger.exception("maintenance scheduling failed for %s", self.collection)
            self._maintenance_last = 0.0
            return False
        return True

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 dtype: str | None = None, *, device: torch.device | str, **kw):
        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        if dtype is None:
            dtype = os.environ.get("MEMEX_INDEX_DTYPE", "float32")
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.flat")
        if self._path and FlatIndex.exists(self._path):
            self.index = FlatIndex.load(self._path, device=device, **kw)
            logger.info("restored collection %s (%d vectors)", collection, self.index.count)
        else:
            self.index = FlatIndex(dim=dim, dtype=dtype, device=device, **kw)
        self._doc_of: dict[str, str] = {}

    @property
    def count(self) -> int:
        return self.index.count - self.index.dead

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        vecs = _normalize(np.stack([d.vector for d in data]))
        with self._lock:
            self.index.add(vecs, [d.id for d in data])
            for d in data:
                self._doc_of[d.id] = d.document_id

    def search(self, vector: np.ndarray, limit: int) -> list[SearchHit]:
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        vecs = _normalize(np.atleast_2d(vectors))
        with self._lock:
            raw = self.index.search(vecs, limit)
        return [[SearchHit(id=sid, score=score, document_id=self._doc_of.get(sid))
                 for sid, score in hits] for hits in raw]

    def delete(self, ids: list[str]) -> int:
        with self._lock:
            n = self.index.delete(ids)
            for sid in ids:
                self._doc_of.pop(sid, None)
            return n

    def delete_all(self) -> None:
        with self._lock:
            self.index.delete_all()
            self._doc_of.clear()
            if self._path:
                type(self.index).remove_checkpoint(self._path)

    def checkpoint(self) -> None:
        if self._path:
            with self._lock:
                self.index.save(self._path)


class MemoryStore:
    """Brute-force store over a float32 tensor on `device`, nothing persisted
    (the `memory://` scheme; hermetic tests)."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384, *,
                 device: torch.device | str, **kw):
        self.collection = collection
        self.dim = dim
        self.device = torch.device(device)
        self._vecs = torch.zeros((0, dim), dtype=torch.float32, device=self.device)
        self._ids: list[str] = []
        self._doc_of: dict[str, str] = {}

    @property
    def count(self) -> int:
        return len(self._ids)

    def add_vectors(self, data: list[VectorData]) -> None:
        if not data:
            return
        vecs = torch.from_numpy(_normalize(np.stack([d.vector for d in data])))
        self._vecs = torch.cat([self._vecs, vecs.to(self.device)])
        self._ids.extend(d.id for d in data)
        for d in data:
            self._doc_of[d.id] = d.document_id

    def search(self, vector, limit: int):
        return self.search_batch(np.asarray(vector)[None, :], limit)[0]

    def search_batch(self, vectors, limit: int):
        vecs = torch.from_numpy(_normalize(np.atleast_2d(vectors))).to(self.device)
        if not self._ids:
            return [[] for _ in range(vecs.shape[0])]
        scores = vecs @ self._vecs.T
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :limit]
        scores, order = scores.cpu().numpy(), order.cpu().numpy()
        return [[SearchHit(id=self._ids[i], score=float(scores[qi, i]),
                           document_id=self._doc_of.get(self._ids[i])) for i in order[qi]]
                for qi in range(len(order))]

    def delete(self, ids: list[str]) -> int:
        drop = set(ids)
        keep = [i for i, sid in enumerate(self._ids) if sid not in drop]
        removed = len(self._ids) - len(keep)
        self._vecs = self._vecs[torch.tensor(keep, dtype=torch.long, device=self.device)]
        self._ids = [self._ids[i] for i in keep]
        for sid in ids:
            self._doc_of.pop(sid, None)
        return removed

    def delete_all(self) -> None:
        self._vecs = torch.zeros((0, self.dim), dtype=torch.float32, device=self.device)
        self._ids = []
        self._doc_of.clear()

    def checkpoint(self) -> None:
        pass
