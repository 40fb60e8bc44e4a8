"""The IVF-tier store (`tpu+ivf://`), port of memex_tpu/store/tpu_store.py's
TpuIVFStore: the flat store's surface over an IVFIndex on the runtime's
device, with spill and delete-churn maintenance that runs as a worker
Maintain task when the runtime wires one."""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from memex_tpu.log import get_logger
from memex_tpu.store.base import SearchHit, VectorData

from ..index.ivf import IVFIndex
from .flat_store import TpuFlatStore, _normalize

logger = get_logger(__name__)


class TpuIVFStore(TpuFlatStore):
    """IVF-tier store; build/rebuild exposed for bulk loads and maintenance.

    URI options besides IVFIndex's: prune_target=<floor> calibrates
    prune_margin on the first search after each (re)build (prune_metric=
    recall measures it against a full-probe baseline instead of the
    unpruned search); recall_target=<floor> calibrates (nprobe,
    prune_margin) jointly."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 n_clusters: int = 1024, nprobe: int = 64, *, device: torch.device | str,
                 **kw):
        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        self._prune_target = kw.pop("prune_target", None)
        self._prune_metric = str(kw.pop("prune_metric", "overlap"))
        self._recall_target = kw.pop("recall_target", None)
        self._calibrated = False
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.ivf")
        if self._path and IVFIndex.exists(self._path):
            self.index = IVFIndex.load(self._path, n_clusters=n_clusters, nprobe=nprobe,
                                       device=device, **kw)
            logger.info("restored IVF collection %s (%d vectors, trained=%s)",
                        collection, self.index.count, self.index.centroids is not None)
        else:
            self.index = IVFIndex(dim=dim, n_clusters=n_clusters, nprobe=nprobe,
                                  device=device, **kw)
        self._doc_of: dict[str, str] = {}

    def build(self, data: list[VectorData]) -> None:
        vecs = _normalize(np.stack([d.vector for d in data]))
        with self._lock:
            self.index.build(vecs, [d.id for d in data])
            for d in data:
                self._doc_of[d.id] = d.document_id
            self._calibrated = False

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        self._maybe_calibrate()
        return super().search_batch(vectors, limit)

    def _maybe_calibrate(self) -> None:
        """Lazy one-shot calibration per build generation, on the first
        search once a cluster table exists."""
        if (self._prune_target is None and self._recall_target is None) or self._calibrated:
            return
        with self._lock:
            if self._calibrated or self.index.data is None:
                return
            if self._recall_target is not None:
                pt = self.index.calibrate_operating_point(target_recall=self._recall_target)
                self._calibrated = True
                logger.info("ivf %s: operating point calibrated to %s (recall target %.2f)",
                            self.collection, pt, self._recall_target)
                return
            m = self.index.calibrate_margin(target_overlap=self._prune_target,
                                            target_metric=self._prune_metric)
            self._calibrated = True
            logger.info("ivf %s: prune_margin calibrated to %s (target %.2f)",
                        self.collection, m, self._prune_target)

    @property
    def needs_recovery(self) -> bool:
        """True when the loaded checkpoint skipped its device-built base:
        the runtime re-streams the rows from SQL."""
        return self.index.needs_recovery

    def recovered(self) -> None:
        self.index.needs_recovery = False

    def add_vectors(self, data: list[VectorData]) -> None:
        super().add_vectors(data)
        if getattr(self, "_recovering", False):
            return  # one rebuild at the end of recovery, not per batch
        # Once the spill outgrows 20% of the corpus (or 4096 rows): fold it
        # into the existing partitions in place (O(spill)); retrain only
        # when the buckets cannot absorb it, on the worker when one is
        # wired, else inline.
        spill = self.index.spill.count
        total = max(self.index.count, 1)
        if spill > 4096 or (total > 1024 and spill * 5 > total):
            folded = 0
            if self.index.dtype == "int8" and self.index.data is not None:
                with self._lock:
                    folded = self.index.fold_spill()
            left = self.index.spill.count
            if left > 4096 or (total > 1024 and left * 5 > total):
                if not self.request_maintenance(f"spill growth ({left}/{total})"):
                    logger.info("ivf %s: auto-rebuild (folded=%d spill=%d total=%d)",
                                self.collection, folded, left, total)
                    self.rebuild()
            elif folded:
                logger.info("ivf %s: folded %d spill rows in place", self.collection, folded)

    def rebuild(self) -> None:
        with self._lock:
            self.index.rebuild()
            self._maintenance_last = 0.0
            if self._prune_target is not None or self._recall_target is not None:
                # Partitions changed; the old operating point is stale.
                self.index.prune_margin = None
                self._calibrated = False

    def delete(self, ids: list[str]) -> int:
        n = super().delete(ids)
        # Tombstones stay until a rebuild and widen the search over-fetch
        # (kk = k + dead): past 25% dead, rebuild.
        if n and not getattr(self, "_recovering", False):
            dead = len(self.index._deleted)
            if dead > 256 and dead * 4 > max(self.index.count, 1):
                if not self.request_maintenance(f"delete churn ({dead} tombstones)"):
                    logger.info("ivf %s: delete-churn rebuild (%d tombstones)",
                                self.collection, dead)
                    self.rebuild()
        return n

    @property
    def count(self) -> int:
        return self.index.count
