"""The port's worker scheduler (`worker/loop.py`) wakes when a slot frees.

With every slot busy the scheduler blocks on a condition that a finishing
task signals, so a queued backlog does not wait out `poll_interval`; with
the queue empty it still polls once a `poll_interval`. The ingest executor
is stubbed with a short sleep over a real SQLite queue, so no model loads.
Every wait here is bounded by a join or a deadline."""

import sys
import threading
import time
from types import SimpleNamespace

import pytest

from memex_tpu_torch.db import queue
from memex_tpu_torch.db.connection import create_connection_by_uri
from memex_tpu_torch.metrics import METRICS
from memex_tpu_torch.worker import Worker
from memex_tpu_torch.worker import tasks as executors

TASK_S = 0.02


def _runtime(tmp_path) -> SimpleNamespace:
    """What `Worker` reads of a runtime: the queue's database, the lease,
    and the checkpoint flush that `shutdown()` calls."""
    return SimpleNamespace(db=create_connection_by_uri(f"sqlite://{tmp_path}/q.db"),
                           settings=SimpleNamespace(task_lease_s=300.0),
                           checkpoint_all=lambda: None)


class _Stub:
    """`process_ingest` stand-in: sleeps `seconds`, or waits for `release`,
    and keeps the peak number of tasks running at once."""

    def __init__(self, release: threading.Event | None = None, seconds: float = TASK_S):
        self.release = release
        self.seconds = seconds
        self.lock = threading.Lock()
        self.running = 0
        self.peak = 0
        self.started = 0

    def __call__(self, rt, task) -> None:
        with self.lock:
            self.running += 1
            self.started += 1
            self.peak = max(self.peak, self.running)
        try:
            if self.release is None:
                time.sleep(self.seconds)
            else:
                assert self.release.wait(30.0)
        finally:
            with self.lock:
                self.running -= 1


def _count(db, status: str) -> int:
    return db.query_one("SELECT COUNT(*) AS n FROM queue WHERE status = ?", (status,))["n"]


def _counter(name: str) -> int:
    return METRICS.snapshot()["counters"].get(name, 0)


def _enqueue(rt, n: int) -> None:
    queue.enqueue_many(rt.db, [("notes", f"doc {i}", queue.TaskType.Ingest) for i in range(n)])


@pytest.fixture(scope="module", params=[5, 2], ids=["max5", "max2"])
def backlog(request, tmp_path_factory):
    """15 queued tasks drained by `start_background()` with a 2 s poll
    interval: the seconds it took, the stub's peak, and the wakes counted."""
    max_active = request.param
    rt = _runtime(tmp_path_factory.mktemp(f"backlog{max_active}"))
    _enqueue(rt, 15)
    stub = _Stub()
    patch = pytest.MonkeyPatch()
    patch.setattr(executors, "process_ingest", stub)
    worker = Worker(rt, max_active=max_active, poll_interval=2.0)
    wakes0 = _counter("worker.slot_wakes")
    t0 = time.monotonic()
    thread = worker.start_background()
    try:
        deadline = t0 + 10.0
        while _count(rt.db, "Completed") < 15 and time.monotonic() < deadline:
            time.sleep(0.005)
        seconds = time.monotonic() - t0
        done = _count(rt.db, "Completed")
    finally:
        worker.shutdown()
        thread.join(5.0)
        patch.undo()
    yield SimpleNamespace(max_active=max_active, seconds=seconds, done=done, peak=stub.peak,
                          wakes=_counter("worker.slot_wakes") - wakes0,
                          stopped=not thread.is_alive())


def test_backlog_is_claimed_as_slots_free_not_on_the_tick(backlog):
    # Without the wake: 5 slots at once, then a 2 s sleep a round, >= 4 s.
    assert backlog.done == 15
    assert backlog.seconds < 1.5, backlog.seconds
    assert backlog.stopped


def test_backlog_never_runs_more_than_max_active(backlog):
    assert 1 <= backlog.peak <= backlog.max_active


def test_backlog_counts_slot_wakes(backlog):
    assert backlog.wakes >= 1


def test_no_wake_is_lost_under_fast_thread_switches(tmp_path, monkeypatch):
    # More slots than cores, short tasks and a 30 s poll interval: a single
    # lost wake would stall the backlog past the deadline.
    rt = _runtime(tmp_path)
    _enqueue(rt, 120)
    stub = _Stub(seconds=0.01)
    monkeypatch.setattr(executors, "process_ingest", stub)
    worker = Worker(rt, max_active=16, poll_interval=30.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        thread = worker.start_background()
        deadline = time.monotonic() + 15.0
        while _count(rt.db, "Completed") < 120 and time.monotonic() < deadline:
            time.sleep(0.01)
        done = _count(rt.db, "Completed")
        worker.shutdown()
        thread.join(5.0)
    finally:
        sys.setswitchinterval(interval)
    assert done == 120
    assert stub.peak <= 16
    assert not thread.is_alive()


def test_empty_queue_polls_once_an_interval(tmp_path):
    rt = _runtime(tmp_path)
    worker = Worker(rt, poll_interval=0.1)
    claims0 = _counter("worker.claim_n")
    thread = worker.start_background()
    try:
        time.sleep(0.5)
        claims = _counter("worker.claim_n") - claims0
    finally:
        worker.shutdown()
        thread.join(5.0)
    assert 1 <= claims <= 8, claims
    assert not thread.is_alive()


@pytest.mark.parametrize("wait", [False, True], ids=["nowait", "wait"])
def test_shutdown_wakes_a_scheduler_waiting_on_full_slots(tmp_path, monkeypatch, wait):
    # wait=True: the running tasks end 0.2 s into shutdown(), which waits for them.
    rt = _runtime(tmp_path)
    _enqueue(rt, 3)
    release = threading.Event()
    stub = _Stub(release)
    monkeypatch.setattr(executors, "process_ingest", stub)
    worker = Worker(rt, max_active=2, poll_interval=5.0)
    thread = worker.start_background()
    try:
        deadline = time.monotonic() + 10.0
        while stub.started < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert stub.started == 2
        time.sleep(0.05)  # the scheduler is now in its wait on full slots
        t0 = time.monotonic()
        if wait:
            threading.Timer(0.2, release.set).start()
        worker.shutdown(wait=wait)
        thread.join(1.0)
        assert time.monotonic() - t0 < 1.0
        assert not thread.is_alive()
    finally:
        release.set()
        worker.shutdown()
        thread.join(5.0)
    assert stub.started == 2
    assert _count(rt.db, "Completed") == 2 and _count(rt.db, "Queued") == 1
