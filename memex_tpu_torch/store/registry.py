"""URI-scheme store factory + process-wide registry (port of
memex_tpu/store/registry.py).

The schemes are memex_tpu's, so an existing deployment's
VECTOR_CONNECTION works unchanged:
  - `tpu://<dir>`      the port's flat store on the runtime's device
  - `tpu+ivf://<dir>`  the port's IVF store on the runtime's device, e.g.
                       `tpu+ivf://./data?n_clusters=1024&nprobe=64&dtype=int8`
  - `memory://`        the port's in-memory store
  - `hnsw://<dir>`     memex_tpu's native C++ HNSW store (no JAX in it)
  - `memex+http(s)://` memex_tpu's remote store (no JAX in it)
The mesh schemes are not ported yet and raise.
"""

from __future__ import annotations

import threading
from urllib.parse import parse_qsl, urlparse

import torch


DEFAULT_DIM = 384  # MiniLM-L12 output

_NOT_PORTED = {
    "tpu+mesh": "ROADMAP.md queue 1 item 12 (sharded tiers)",
    "tpu+ivf+mesh": "ROADMAP.md queue 1 item 12 (sharded tiers)",
}

_INT_OPTS = {"capacity", "n_clusters", "nprobe", "M", "ef_construction",
             "ef_search", "capacity_per_shard", "block_n", "rerank"}
_BOOL_OPTS = {"query_quantize", "use_fused", "scan_int4", "center", "refine"}
_FLOAT_OPTS = {"prune_margin", "prune_target", "recall_target", "bucket_factor"}


class StoreRegistry:
    """Live store handles keyed by (uri, collection), built once."""

    def __init__(self):
        self._stores: dict = {}
        self._lock = threading.Lock()

    def get(self, uri: str, collection: str, dim: int = DEFAULT_DIM, *,
            device: torch.device | str):
        key = (uri, collection)
        with self._lock:
            store = self._stores.get(key)
            if store is None:
                store = _build_store(uri, collection, dim, torch.device(device))
                self._stores[key] = store
            return store

    def drop(self, uri: str, collection: str) -> None:
        with self._lock:
            self._stores.pop((uri, collection), None)

    def checkpoint_all(self) -> None:
        with self._lock:
            stores = list(self._stores.values())
        for s in stores:
            s.checkpoint()


_REGISTRY = StoreRegistry()


def get_vector_storage(uri: str, collection: str, dim: int = DEFAULT_DIM, *,
                       device: torch.device | str):
    """Process-wide store lookup (live handle, not a fresh load)."""
    return _REGISTRY.get(uri, collection, dim, device=device)


def _build_store(uri: str, collection: str, dim: int, device: torch.device):
    """Scheme selects the backend; query parameters pass backend options,
    e.g. `tpu://./data?dtype=bfloat16&rerank=64`."""
    parsed = urlparse(uri)
    scheme = parsed.scheme or "tpu"
    path = (parsed.netloc + parsed.path) or "./vector_data"
    opts: dict = {}
    for key, val in parse_qsl(parsed.query):
        if key in _INT_OPTS:
            opts[key] = int(val)
        elif key in _BOOL_OPTS:
            opts[key] = val.lower() not in ("0", "false", "no", "off")
        elif key in _FLOAT_OPTS:
            opts[key] = float(val)
        else:
            opts[key] = val
    if scheme in _NOT_PORTED:
        raise NotImplementedError(
            f"vector store scheme {scheme!r} is not ported yet: {_NOT_PORTED[scheme]}")
    if scheme == "tpu":
        from .flat_store import TpuFlatStore

        return TpuFlatStore(path, collection, dim=dim, device=device, **opts)
    if scheme == "tpu+ivf":
        from .ivf_store import TpuIVFStore

        return TpuIVFStore(path, collection, dim=dim, device=device, **opts)
    if scheme == "memory":
        from .flat_store import MemoryStore

        return MemoryStore(None, collection, dim=dim, device=device)
    if scheme == "hnsw":
        from memex_tpu.store.hnsw_store import HnswStore

        return HnswStore(path, collection, dim=dim, **opts)
    if scheme in ("memex+http", "memex+https"):
        from memex_tpu.store.remote import RemoteStore

        base = f"{scheme.split('+')[1]}://{path}"
        return RemoteStore(base, collection, dim=dim, **opts)
    raise ValueError(f"unsupported vector store scheme: {scheme!r} (uri {uri!r})")
