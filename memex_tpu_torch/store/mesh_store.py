"""The sharded stores (port of memex_tpu/store/tpu_store.py's TpuMeshStore
and TpuMeshIVFStore): `tpu+mesh://` puts a ShardedFlatIndex, and
`tpu+ivf+mesh://` a ShardedIVFIndex, over every card of the runtime's
device type (parallel/mesh.py::local_mesh), with memex_tpu's checkpoint
files, lazy calibration and maintenance rules."""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..index.sharded import ShardedFlatIndex
from ..index.sharded_ivf import ShardedIVFIndex
from ..log import get_logger
from ..parallel.mesh import local_mesh
from .base import SearchHit
from .flat_store import TpuFlatStore
from .ivf_store import TpuIVFStore

logger = get_logger(__name__)


class TpuMeshStore(TpuFlatStore):
    """Flat store with its rows sharded over the local cards and a top-k
    merge on the first (`tpu+mesh://`)."""

    def __init__(self, base_dir: str | None, collection: str, dim: int = 384,
                 capacity_per_shard: int = 65536, *, device: torch.device | str, **kw):
        self.collection = collection
        self.dim = dim
        self._lock = threading.Lock()
        self._path = None
        if base_dir:
            os.makedirs(base_dir, exist_ok=True)
            self._path = os.path.join(base_dir, f"{collection}.mesh")
        self.index = ShardedFlatIndex(dim, local_mesh(device),
                                      capacity_per_shard=capacity_per_shard, **kw)
        self._doc_of: dict[str, str] = {}
        if self._path and os.path.exists(self._path + ".meta.json"):
            n = self.index.restore(self._path)
            logger.info("restored mesh collection %s (%d vectors)", collection, n)

    @property
    def count(self) -> int:
        return self.index.count


class TpuMeshIVFStore(TpuIVFStore):
    """IVF store with its clusters sharded over the local cards
    (`tpu+ivf+mesh://`): TpuIVFStore's calibration and maintenance, with
    memex_tpu's spill rule for this tier and the rebuild that a search
    answered by the exact fallback asks for."""

    SPILL_ROWS, SPILL_MIN_TOTAL = 16384, 4096
    needs_recovery = False  # its checkpoints always hold their base

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
            self._path = os.path.join(base_dir, f"{collection}.ivfmesh")
        self.index = ShardedIVFIndex(dim, local_mesh(device), n_clusters=n_clusters,
                                     nprobe=nprobe, **kw)
        self._doc_of: dict[str, str] = {}
        if self._path and os.path.exists(self._path + ".meta.json"):
            n = self.index.restore(self._path)
            logger.info("restored sharded-IVF collection %s (%d vectors)", collection, n)

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        out = super().search_batch(vectors, limit)
        # The index flags (never runs) maintenance after a shortfall answered
        # by its exact pass: schedule the rebuild on the worker.
        if self.index.maintenance_needed and self.request_maintenance("search shortfall fallback"):
            self.index.maintenance_needed = False
        return out
