"""The sharded stores (port of memex_tpu/store/tpu_store.py's TpuMeshStore
and TpuMeshIVFStore): `tpu+mesh://` puts a ShardedFlatIndex, and
`tpu+ivf+mesh://` a ShardedIVFIndex, over every card of the runtime's
device type (parallel/mesh.py::local_mesh), with memex_tpu's checkpoint
files, lazy calibration and maintenance rules. After init_multihost the
index spans the process group: these cards are this rank's shards, and
every rank keeps its own copy of the checkpoint files."""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..index.sharded import ShardedFlatIndex
from ..index.sharded_ivf import ShardedIVFIndex
from ..log import get_logger
from ..parallel.collectives import check_same
from ..parallel.distributed import default_group
from ..parallel.mesh import local_mesh
from .base import SearchHit
from .flat_store import TpuFlatStore
from .ivf_store import TpuIVFStore

logger = get_logger(__name__)


class _RankedCheckpoints:
    """Checkpoint rules of a store whose index may span a process group.

    Every rank restores and saves its own copy of the same files, and the
    sharded IVF's save and restore meet the other ranks at collectives, so
    every rank must make the same choices. A clock or a file differs
    between ranks; the ingests do not, since every rank takes the same ones
    in the same order. So under a group a store saves after its first
    ingest and every CHECKPOINT_EVERY-th after it (the runtime's clock
    decides on one controller), and the ranks check that they restore the
    same checkpoint, raising when they do not."""

    CHECKPOINT_EVERY = 256
    _ingests = 0

    def checkpoint_due(self) -> bool | None:
        """Whether this ingest's checkpoint is due, from the count of
        ingests (None on one controller: the runtime's clock decides)."""
        if self.index.group is None:
            return None
        with self._lock:
            due = self._ingests % self.CHECKPOINT_EVERY == 0
            self._ingests += 1
        return due

    def _restore_if_saved(self, kind: str) -> None:
        group = self.index.group
        saved = bool(self._path) and os.path.exists(self._path + ".meta.json")
        if not check_same(saved, group, f"whether {self._path} holds a checkpoint"):
            return
        n = check_same(self.index.restore(self._path), group, f"the rows of {self._path}")
        logger.info("restored %s collection %s (%d vectors)", kind, self.collection, n)


class TpuMeshStore(_RankedCheckpoints, TpuFlatStore):
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
                                      capacity_per_shard=capacity_per_shard,
                                      group=default_group(), **kw)
        self._doc_of: dict[str, str] = {}
        self._restore_if_saved("mesh")

    @property
    def count(self) -> int:
        return self.index.count


class TpuMeshIVFStore(_RankedCheckpoints, TpuIVFStore):
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
                                     nprobe=nprobe, group=default_group(), **kw)
        self._doc_of: dict[str, str] = {}
        self._restore_if_saved("sharded-IVF")

    def search_batch(self, vectors: np.ndarray, limit: int) -> list[list[SearchHit]]:
        out = super().search_batch(vectors, limit)
        # The index flags (never runs) maintenance after a shortfall answered
        # by its exact pass: schedule the rebuild on the worker.
        if self.index.maintenance_needed and self.request_maintenance("search shortfall fallback"):
            self.index.maintenance_needed = False
        return out
