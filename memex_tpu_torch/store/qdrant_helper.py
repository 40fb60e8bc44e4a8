"""Qdrant connection helper (a copy of memex_tpu/store/qdrant_helper.py).

Parity with the reference's orphaned qdrant module
(lib/libmemex/src/storage/qdrant.rs:8-44 — connect + ensure a 384-d cosine
collection; not wired into the store factory there either). Implemented
against Qdrant's REST API with `requests`; useful for exporting a
collection to an external Qdrant instance.
"""

from __future__ import annotations

import requests

from ..log import get_logger

logger = get_logger(__name__)

DEFAULT_DIM = 384  # reference qdrant.rs:25-31


class QdrantHelper:
    def __init__(self, base_url: str = "http://localhost:6333", timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def healthy(self) -> bool:
        try:
            return requests.get(f"{self.base_url}/healthz", timeout=self.timeout).ok
        except requests.RequestException:
            return False

    def ensure_collection(self, name: str, dim: int = DEFAULT_DIM, on_disk: bool = True) -> bool:
        """Create the collection if missing (cosine distance, optionally
        on-disk vectors — reference qdrant.rs:25-31). Returns True if the
        collection exists afterwards."""
        resp = requests.get(f"{self.base_url}/collections/{name}", timeout=self.timeout)
        if resp.ok:
            return True
        resp = requests.put(
            f"{self.base_url}/collections/{name}",
            json={"vectors": {"size": dim, "distance": "Cosine", "on_disk": on_disk}},
            timeout=self.timeout,
        )
        if not resp.ok:
            logger.warning("qdrant create collection failed: %s", resp.text[:200])
        return resp.ok
