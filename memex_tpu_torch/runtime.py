"""TorchRuntime: memex_tpu's Runtime with the port's device-side pieces.

memex_tpu.runtime.Runtime is JAX-free at import but builds its engine,
batcher and stores from the JAX package. This subclass overrides exactly
those seams (`engine`, `search_batcher`, `store`, `checkpoint_all`,
`drop_store`) and inherits the rest: `db`, `encode_doc`, `add_vectors`,
maintenance scheduling (`_enqueue_maintenance`) and the checkpoint
cadence. The API server
(`memex_tpu.api.server.create_app/start_async`) and the worker
(`memex_tpu.worker.Worker`) take a TorchRuntime as they take a Runtime.
"""

from __future__ import annotations

import os
import threading

import torch

from memex_tpu.config import Settings
from memex_tpu.runtime import Runtime

from .store.registry import _REGISTRY, get_vector_storage


class TorchRuntime(Runtime):
    def __init__(self, settings: Settings | None = None, *, device: torch.device | str):
        super().__init__(settings)
        self.device = torch.device(device)

    @property
    def engine(self):
        with self._lock:
            if self._engine is None:
                from .embed import EmbeddingEngine

                self._engine = EmbeddingEngine(
                    model_dir=self.settings.embedding_model,
                    max_seq_length=self.settings.max_seq_length,
                    window_stride=self.settings.window_stride,
                    device=self.device,
                )
            return self._engine

    @property
    def search_batcher(self):
        with self._lock:
            if self._batcher is None:
                from .serve.batcher import SearchBatcher

                self._batcher = SearchBatcher(self, max_batch=self.settings.search_max_batch)
            return self._batcher

    @property
    def llm(self):
        # memex_tpu's get_llm builds the local JAX model for LOCAL_LLM_CONFIG
        # when neither the fake LLM nor an OpenAI key takes precedence.
        if (self.settings.local_llm_config and not os.environ.get("MEMEX_FAKE_LLM")
                and not self.settings.openai_api_key):
            raise RuntimeError(
                "LOCAL_LLM_CONFIG selects the local LLM, which the PyTorch port "
                "does not have yet (ROADMAP.md queue 1 item 13); unset it, or set "
                "OPENAI_API_KEY or MEMEX_FAKE_LLM=1")
        return super().llm

    def store(self, collection: str):
        """The collection's store on this runtime's device, its maintenance
        wired to the worker queue. On first touch per process, an empty (or
        partially restored) store is rebuilt from SQL under a per-collection
        lock, as memex_tpu's Runtime.store does."""
        store = get_vector_storage(self.settings.vector_uri, collection,
                                   dim=self.settings.embedding_dim, device=self.device)
        # O(corpus) maintenance (IVF retrains) runs as worker Maintain tasks.
        if getattr(store, "on_maintenance", "absent") is None:
            store.on_maintenance = self._enqueue_maintenance
        if collection not in self._rebuilt:
            with self._lock:
                rl = self._recovery_locks.setdefault(collection, threading.RLock())
            with rl:
                if collection not in self._rebuilt:
                    # Mark before rebuilding: the rebuild re-enters store().
                    self._rebuilt.add(collection)
                    needs = getattr(store, "needs_recovery", False)
                    if store.count == 0 or needs:
                        from memex_tpu.recovery import rebuild_collection

                        try:
                            rebuild_collection(self, collection, force=needs)
                        except BaseException:
                            # A failed rebuild is retried on the next touch.
                            self._rebuilt.discard(collection)
                            raise
        return store

    def checkpoint_all(self) -> None:
        """Flush every live store (shutdown path)."""
        _REGISTRY.checkpoint_all()

    def drop_store(self, collection: str) -> None:
        _REGISTRY.drop(self.settings.vector_uri, collection)
