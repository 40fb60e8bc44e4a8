"""Worker scheduler loop.

Reference: run_scheduler polls every 100ms with max 5 active jobs
(lib/worker/src/lib.rs:118-166, WorkerInstanceLimits :27-45); run_task
wraps execution with timing + mark_done/mark_failed (:249-273); retries
requeue up to MAX_RETRIES then park as Failed (db/queue.rs:114-130).

The scheduler waits in one of two ways when it cannot claim. With every
slot busy it blocks on a condition that a finishing task signals, so a
queued backlog is claimed the moment a slot frees (`worker.slot_wakes`
counts those wakes); the wait times out after `poll_interval`, which keeps
the reap on schedule. With a slot free and the queue empty it sleeps
`poll_interval`, as the reference polls: tasks arrive over SQL (from the
API or other worker processes), which no event in this process sees.

Thread-pool execution replaces tokio task spawning; the claim itself is an
atomic UPDATE..RETURNING so multiple worker processes can share one queue
(the reference's only multi-process mechanism, SURVEY.md §1).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..db import queue
from ..log import get_logger
from ..metrics import METRICS
from ..runtime import TorchRuntime, get_runtime
from . import tasks as executors

logger = get_logger(__name__)

POLL_INTERVAL_S = 0.1   # reference lib.rs:124
MAX_ACTIVE = 5          # reference lib.rs:27-45
REAP_EVERY_S = 10.0


class Worker:
    def __init__(self, runtime: TorchRuntime | None = None, max_active: int = MAX_ACTIVE,
                 poll_interval: float = POLL_INTERVAL_S):
        self.rt = runtime or get_runtime()
        self.max_active = max_active
        self.poll_interval = poll_interval
        self._active = 0
        self._freed: deque[float] = deque()  # when each free slot last freed (FIFO)
        self._lock = threading.Lock()
        self._slot_freed = threading.Condition(self._lock)
        self._shutdown = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=max_active, thread_name_prefix="memex-worker")
        self._last_reap = 0.0

    # -- job execution ---------------------------------------------------------

    def _run_task(self, task: queue.Task) -> None:
        """Timing + completion wrapper (reference run_task, lib.rs:249-273)."""
        t0 = time.perf_counter()
        try:
            with METRICS.span("worker.task"):
                if task.task_type == queue.TaskType.Ingest:
                    output = executors.process_ingest(self.rt, task)
                elif task.task_type == queue.TaskType.Summarize:
                    output = executors.process_summarize(self.rt, task)
                elif task.task_type == queue.TaskType.Extract:
                    output = executors.process_extract(self.rt, task)
                elif task.task_type == queue.TaskType.Maintain:
                    output = executors.process_maintain(self.rt, task)
                else:
                    raise ValueError(f"unknown task type {task.task_type}")
                queue.mark_done(self.rt.db, task.id, task_output=output)
            logger.info(
                "job %d (%s) finished in %.0fms",
                task.id, task.task_type.value, (time.perf_counter() - t0) * 1000,
            )
        except Exception as exc:
            logger.exception("job %d failed", task.id)
            queue.mark_failed(
                self.rt.db, task.id, retry=True,
                error={"error": str(exc), "type": type(exc).__name__},
            )
        finally:
            with self._lock:
                self._active -= 1
                self._freed.append(time.perf_counter())
                self._slot_freed.notify()

    # -- scheduler -------------------------------------------------------------

    def poll_once(self) -> bool:
        """One scheduler tick; returns True if a job was claimed."""
        now = time.monotonic()
        if now - self._last_reap > REAP_EVERY_S:
            reaped = queue.reap_expired(self.rt.db)
            if reaped:
                logger.warning("reaped %d orphaned Processing tasks", reaped)
            self._last_reap = now
        with self._lock:
            if self._active >= self.max_active:
                return False
        with METRICS.span("worker.claim"):
            task = queue.check_for_jobs(self.rt.db, lease_s=self.rt.settings.task_lease_s)
        if task is None:
            return False
        with self._lock:
            self._active += 1
            # A slot that freed before this claim waited this long for it.
            freed = self._freed.popleft() if self._freed else None
        if freed is not None:
            METRICS.add_span("worker.slot_idle", time.perf_counter() - freed)
        logger.info("claimed task %d (%s)", task.id, task.task_type.value)
        try:
            self._pool.submit(self._run_task, task)
        except RuntimeError:
            # shutdown() closed the pool between the claim and the submit:
            # return the task to the queue (no retry burned — it was never
            # attempted) instead of letting it ride out its lease as
            # Processing and killing the scheduler thread.
            with self._lock:
                self._active -= 1
            queue.requeue(self.rt.db, task.id)
            logger.info("requeued task %d: pool closed during claim", task.id)
            return False
        return True

    def run(self) -> None:
        logger.info("worker started (max_active=%d, poll=%.0fms)",
                    self.max_active, self.poll_interval * 1000)
        while not self._shutdown.is_set():
            full = self._wait_while_full()
            if self._shutdown.is_set():
                break
            if not self.poll_once() and not full:
                # A slot was free and the queue empty: poll for new tasks.
                self._shutdown.wait(self.poll_interval)

    def _wait_while_full(self) -> bool:
        """With every slot busy, wait until a task frees one, shutdown()
        is called or `poll_interval` passes (so poll_once's reap keeps
        its schedule); returns whether every slot is still busy. Only this
        thread fills slots, so a slot seen free stays free for the claim."""
        with self._lock:
            if self._active < self.max_active:
                return False
            freed = self._slot_freed.wait_for(
                lambda: self._active < self.max_active or self._shutdown.is_set(),
                self.poll_interval)
        if freed and not self._shutdown.is_set():
            METRICS.inc("worker.slot_wakes")
        return not freed

    def start_background(self) -> threading.Thread:
        thread = threading.Thread(target=self.run, name="memex-scheduler", daemon=True)
        thread.start()
        return thread

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown.set()
        with self._lock:
            self._slot_freed.notify_all()
        self._pool.shutdown(wait=wait)
        try:
            self.rt.checkpoint_all()  # rate-limited ingest ckpts flush here
        except Exception:
            logger.exception("checkpoint on shutdown failed")

    def drain(self, timeout: float = 60.0) -> bool:
        """Process queued tasks until the queue is empty and no jobs are
        active (test/CLI helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            claimed = self.poll_once()
            if claimed:
                continue  # fill the worker pool immediately: staggered
                # claims fragment the encode/store microbatch windows
            with self._lock:
                active = self._active
            if active == 0:
                row = self.rt.db.query_one(
                    "SELECT COUNT(*) AS n FROM queue WHERE status IN ('Queued','Processing')"
                )
                if row["n"] == 0:
                    return True
            time.sleep(0.01)
        return False


def start(runtime: TorchRuntime | None = None) -> None:
    Worker(runtime).run()
