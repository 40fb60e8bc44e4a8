"""Process-wide runtime context: settings, DB, embedding engine, LLM, stores.

The reference constructs these per-request/per-job (its dominant latency —
SURVEY.md §3 hot spots); here every expensive resource is built once per
process and shared by the API handlers and worker executors. The encoder
and the vector stores live on the runtime's torch device.
"""

from __future__ import annotations

import threading
import time

import torch

from .config import Settings
from .db.connection import Database, create_connection_by_uri
from .log import get_logger
from .store.registry import _REGISTRY, get_vector_storage

logger = get_logger(__name__)


def require_device(name: str, command: str) -> torch.device | None:
    """`name` as a torch device, or None (logged) when it names CUDA and
    there is no card: a command run without `--device cpu` never moves to
    the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("--device %s requested but CUDA is not available "
                     "(use --device cpu to run %s on the CPU)", name, command)
        return None
    return device


class TorchRuntime:
    def __init__(self, settings: Settings | None = None, *,
                 device: torch.device | str = "cuda"):
        self.settings = settings or Settings.from_env()
        self.device = torch.device(device)
        # RLock: store() holds it across a rebuild that re-enters via self.db.
        self._lock = threading.RLock()
        self._db: Database | None = None
        self._engine = None
        self._llm = None
        self._batcher = None
        self._encode_batcher = None
        self._add_batcher = None
        self._rebuilt: set[str] = set()
        # Per-collection recovery locks: a first-touch rebuild re-adds every
        # row of the collection from SQL (millions of rows); holding the
        # global RLock for that long would stall every unrelated runtime
        # operation (db/engine/llm properties, other collections' batched
        # writes).
        self._recovery_locks: dict[str, threading.RLock] = {}
        self._last_ckpt: dict[str, float] = {}

    @property
    def db(self) -> Database:
        with self._lock:
            if self._db is None:
                self._db = create_connection_by_uri(self.settings.db_uri, run_migrations=True)
            return self._db

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
    def llm(self):
        with self._lock:
            if self._llm is None:
                from .llm.base import get_llm

                self._llm = get_llm(self.settings, device=self.device)
            return self._llm

    @property
    def search_batcher(self):
        with self._lock:
            if self._batcher is None:
                from .serve.batcher import SearchBatcher

                self._batcher = SearchBatcher(
                    self, max_batch=self.settings.search_max_batch
                )
            return self._batcher

    def encode_doc(self, text: str):
        """Document encode through a microbatcher: up to `worker_max_active`
        concurrent ingest tasks share one device-call stream."""
        with self._lock:
            if self._encode_batcher is None:
                from .serve.batcher import Microbatcher

                self._encode_batcher = Microbatcher(
                    self.engine.encode_many,
                    max_batch=max(2, self.settings.worker_max_active),
                    max_wait_ms=5.0,
                    name="encode",
                )
        return self._encode_batcher(text, timeout=600.0)

    def add_vectors(self, collection: str, items: list) -> None:
        """Store writes through a microbatcher: concurrent ingest tasks on
        the same collection share one store write, so the store lock, the
        host quantization and the copy to the device are paid once for
        several tasks."""
        with self._lock:
            if self._add_batcher is None:
                from .serve.batcher import Microbatcher

                def _run(batch):
                    # Per-collection failure isolation: one collection's
                    # failed write must not poison waiters whose writes
                    # already committed (they would retry committed work).
                    by_col: dict[str, list] = {}
                    for col, vecs in batch:
                        by_col.setdefault(col, []).extend(vecs)
                    outcome: dict[str, Exception | None] = {}
                    for col, vecs in by_col.items():
                        try:
                            self.store(col).add_vectors(vecs)
                            outcome[col] = None
                        except Exception as exc:  # noqa: BLE001 — re-raised per item
                            logger.exception("store add failed for %r", col)
                            outcome[col] = exc
                    return [outcome[col] for col, _ in batch]

                self._add_batcher = Microbatcher(
                    _run,
                    max_batch=max(2, self.settings.worker_max_active),
                    max_wait_ms=5.0,
                    name="store_add",
                )
        err = self._add_batcher((collection, items), timeout=600.0)
        if err is not None:
            raise err

    def _enqueue_maintenance(self, collection: str, reason: str) -> None:
        """Schedule an index rebuild on the worker queue (dedup: one
        pending Maintain per collection services any number of triggers).
        Maintenance never runs on the path that noticed the need — the
        verdict-2 fix for k-means-inside-search."""
        from .db import queue

        if queue.has_pending(self.db, collection, queue.TaskType.Maintain):
            return
        queue.enqueue(self.db, collection, reason, queue.TaskType.Maintain)
        logger.info("scheduled maintenance for %r (%s)", collection, reason)

    def store(self, collection: str):
        store = get_vector_storage(
            self.settings.vector_uri, collection, dim=self.settings.embedding_dim,
            device=self.device,
        )
        # Wire background maintenance for stores that support it (TPU IVF
        # tiers): O(corpus) retrains become worker tasks, not inline work.
        if getattr(store, "on_maintenance", "absent") is None:
            store.on_maintenance = self._enqueue_maintenance
        # First touch per process: if the device index is empty but SQL has
        # rows (restart without a checkpoint), rebuild from the source of
        # truth (SURVEY.md §5 checkpoint/resume). Check-and-rebuild happens
        # under a PER-COLLECTION lock: API threads, the batcher, and worker
        # threads can first-touch concurrently (two rebuilds would double
        # every row), but one collection's minutes-long rebuild must not
        # stall the rest of the runtime behind the global lock.
        if collection not in self._rebuilt:
            with self._lock:
                rl = self._recovery_locks.setdefault(collection, threading.RLock())
            with rl:
                if collection not in self._rebuilt:
                    # Mark BEFORE rebuilding: rebuild_collection re-enters
                    # store() on this thread (RLock) and must not recurse.
                    self._rebuilt.add(collection)
                    needs = getattr(store, "needs_recovery", False)
                    if store.count == 0 or needs:
                        from .recovery import rebuild_collection

                        try:
                            rebuild_collection(self, collection, force=needs)
                        except BaseException:
                            # Roll back the mark: a failed rebuild must be
                            # retried on the next touch, not remembered as
                            # done for the process lifetime (silently empty
                            # search results until restart).
                            self._rebuilt.discard(collection)
                            raise
        return store

    def maybe_checkpoint(self, collection: str, store, interval_s: float | None = None) -> bool:
        """Checkpoint at most once per `interval_s` per collection (SQL is
        the durable source of truth; the device checkpoint is a warm-start
        optimization, so per-ingest O(count) saves are wasted work)."""
        if interval_s is None:
            interval_s = self.settings.checkpoint_interval_s
        # A store over a process group decides from what every rank holds
        # alike (store/mesh_store.py); None leaves it to this clock.
        due = getattr(store, "checkpoint_due", lambda: None)()
        if due is None:
            now = time.monotonic()
            with self._lock:
                last = self._last_ckpt.get(collection)
                due = last is None or now - last >= interval_s
                if due:
                    self._last_ckpt[collection] = now
        if not due:
            return False
        store.checkpoint()
        return True

    def checkpoint_all(self) -> None:
        """Flush every live store (shutdown path)."""
        _REGISTRY.checkpoint_all()

    def drop_store(self, collection: str) -> None:
        _REGISTRY.drop(self.settings.vector_uri, collection)


_runtime: TorchRuntime | None = None
_runtime_lock = threading.Lock()


def get_runtime(settings: Settings | None = None) -> TorchRuntime:
    """The process's runtime, built on first call on the default device
    (cuda); a caller that wants another device builds its TorchRuntime and
    passes it to create_app / Worker."""
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = TorchRuntime(settings)
        return _runtime


def reset_runtime() -> None:
    global _runtime
    with _runtime_lock:
        _runtime = None
