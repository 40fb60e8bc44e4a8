"""Counters, spans and the MEMEX_PROFILE trace.

The reference's observability is logs + a per-response `time` field only
(SURVEY.md §5: no metrics export, no profiler). Here:

  - process-wide counters and per-route timings, exposed at GET /api/stats;
  - `METRICS.span(name)`: a block's microseconds added to the counter
    `<name>_us` and 1 to `<name>_n`; while a torch.profiler session runs,
    the block is also a `record_function(name)`, on the trace's clock
    beside the kernels. `add_span` counts a span that starts on one
    thread and ends on another (or across an `await`): counters only;
  - `add_device(name, value)`: a counter kept on the device (no host
    read where it is added), read by `snapshot()`;
  - `device_timing()`: a scope in which `device_span(name, device)`
    blocks record CUDA events (the host clock on the CPU); `count()`,
    called after the caller's own host read, adds each finished block's
    device seconds to `<name>_us` / `<name>_n` with no wait of its own;
  - `profile_trace()`: with MEMEX_PROFILE=<dir>, one torch.profiler trace
    of every thread, `<dir>/memex.json`, over PROFILE_WINDOW_S seconds from
    the first batch any batcher collects.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

from .log import get_logger

logger = get_logger(__name__)

PROFILE_WINDOW_S = 10.0


class _Span:
    """One `Metrics.span` block. The global flag read on entry costs a
    module attribute lookup; `record_function` itself costs ~10-15 us, so
    it is entered only while a session runs."""

    __slots__ = ("_metrics", "_name", "_keys", "_t0", "_rf")

    def __init__(self, metrics: "Metrics", name: str, keys: tuple[str, str]):
        self._metrics = metrics
        self._name = name
        self._keys = keys
        self._rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        us = (time.perf_counter_ns() - self._t0 + 500) // 1000
        m, (k_us, k_n) = self._metrics, self._keys
        with m._lock:
            m._counters[k_us] += us
            m._counters[k_n] += 1
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class DeviceTiming:
    """The device spans of one thread's scope (`Metrics.device_timing()`):
    CUDA event pairs on a card, host clock readings on the CPU, where every
    operation has ended when it returns. Counted by `count()` once the
    caller has read a result that the spans' work precedes."""

    def __init__(self, metrics: "Metrics"):
        self._metrics = metrics
        self._spans: list = []  # [name, start, end, counters]
        self._outer = None

    def __enter__(self):
        self._outer = getattr(self._metrics._tls, "timing", None)
        self._metrics._tls.timing = self
        return self

    def __exit__(self, *exc):
        self._metrics._tls.timing = self._outer
        return False

    def mark(self, device: torch.device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, device: torch.device, counters: dict | None = None):
        entry = [name, self.mark(device), None, counters or {}]
        try:
            yield
        finally:
            entry[2] = self.mark(device)
            self._spans.append(entry)

    def count(self) -> None:
        """Add every span whose end the device has passed (an event not yet
        reached, as a speculative chunk nobody read, is dropped with its
        counters) and forget them all. Reads no value back beyond what
        the events already hold."""
        m = self._metrics
        for name, start, end, counters in self._spans:
            if isinstance(end, float):
                secs = end - start
            elif end.query():
                secs = start.elapsed_time(end) / 1e3
            else:
                continue
            m.add_span(name, secs)
            for k, v in counters.items():
                m.inc(k, v)
        self._spans.clear()


class Metrics:
    def __init__(self):
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._counters: dict[str, int] = defaultdict(int)
        self._timings: dict[str, list[float]] = defaultdict(list)
        self._keys: dict[str, tuple[str, str]] = {}
        self._device: dict[tuple[str, str], torch.Tensor] = {}
        self._started = time.time()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def span(self, name: str) -> _Span:
        """Context manager: the block's time in `<name>_us` and `<name>_n`
        (also when it raises), and a profiler annotation while a session
        runs. The block must start and end on one thread."""
        keys = self._keys.get(name) or self._span_keys(name)
        return _Span(self, name, keys)

    def add_span(self, name: str, seconds: float, n: int = 1) -> None:
        """Add `n` spans of `seconds` in all to `<name>_us` / `<name>_n`."""
        k_us, k_n = self._keys.get(name) or self._span_keys(name)
        us = round(seconds * 1e6)
        with self._lock:
            self._counters[k_us] += us
            self._counters[k_n] += n

    def device_timing(self) -> DeviceTiming:
        """A scope (`with METRICS.device_timing() as t:`) whose
        `device_span` blocks on this thread are timed on the device; call
        `t.count()` after the host read that follows them."""
        return DeviceTiming(self)

    def device_span(self, name: str, device: torch.device, counters: dict | None = None):
        """A block timed on `device` as `<name>_us` / `<name>_n`, with
        `counters` added beside it, inside this thread's `device_timing()`
        scope; elsewhere a no-op."""
        timing = getattr(self._tls, "timing", None)
        if timing is None:
            return contextlib.nullcontext()
        return timing.span(name, torch.device(device), counters)

    def _span_keys(self, name: str) -> tuple[str, str]:
        return self._keys.setdefault(name, (name + "_us", name + "_n"))

    def add_device(self, name: str, value: torch.Tensor) -> None:
        """Add a device scalar to the counter `name`, on that device: no
        host read here; `snapshot()` reads it."""
        key = (name, str(value.device))
        with self._lock:
            acc = self._device.get(key)
            if acc is None:
                acc = self._device[key] = torch.zeros((), dtype=torch.int64,
                                                      device=value.device)
            acc.add_(value)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                window = self._timings[name]
                window.append(dt)
                if len(window) > 1024:  # bounded ring
                    del window[: len(window) - 1024]

    def snapshot(self) -> dict:
        with self._lock:
            device = list(self._device.items())
        # Each read waits for the work queued before it on that device:
        # outside the lock, so spans on other threads do not wait too.
        read: dict[str, int] = defaultdict(int)
        for (name, _), acc in device:
            read[name] += int(acc.item())
        with self._lock:
            timings = {}
            for name, window in self._timings.items():
                if not window:
                    continue
                s = sorted(window)
                timings[name] = {
                    "count": len(s),
                    "p50_ms": round(s[len(s) // 2] * 1e3, 3),
                    "p99_ms": round(s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3, 3),
                    "mean_ms": round(sum(s) / len(s) * 1e3, 3),
                }
            return {
                "uptime_s": round(time.time() - self._started, 1),
                "counters": {**self._counters, **read},
                "timings": timings,
            }


METRICS = Metrics()


class _ProfileWindow:
    """The process's one MEMEX_PROFILE trace. With every thread profiled,
    a thread of its own starts the session, sleeps PROFILE_WINDOW_S and
    writes the trace. A torch that cannot profile every thread records
    only the thread that starts the session, and only that thread may end
    it: the calling thread then starts it and ends it on its first call
    past the window."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started = False
        self._local = None  # (thread id, deadline, session, path): fallback only

    def tick(self) -> None:
        if self.started:
            local = self._local
            if (local is not None and local[0] == threading.get_ident()
                    and time.monotonic() >= local[1]):
                self._local = None
                _write(local[2], local[3])
            return
        trace_dir = os.environ.get("MEMEX_PROFILE")
        if not trace_dir:
            return
        with self._lock:
            if self.started:
                return
            self.started = True
        path = os.path.join(trace_dir, "memex.json")
        config = _all_threads_config()
        if config is None:
            session = _session(None)
            session.start()
            self._local = (threading.get_ident(), time.monotonic() + PROFILE_WINDOW_S,
                           session, path)
            return
        threading.Thread(target=self._run, args=(config, path), name="memex-profile",
                         daemon=True).start()

    def _run(self, config, path: str) -> None:
        session = _session(config)
        session.start()
        time.sleep(PROFILE_WINDOW_S)
        _write(session, path)


def _all_threads_config():
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        logger.warning("torch %s cannot profile every thread: the MEMEX_PROFILE trace "
                       "holds only the thread that collected the first batch",
                       torch.__version__)
        return None


def _session(config):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, experimental_config=config)


def _write(session, path: str) -> None:
    session.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    session.export_chrome_trace(path)
    logger.info("MEMEX_PROFILE: wrote %s (%.0f s)", path, PROFILE_WINDOW_S)


_PROFILE = _ProfileWindow()


def profile_trace() -> None:
    """Start the MEMEX_PROFILE=<dir> trace (`<dir>/memex.json`: every
    thread's host ops and spans, and the CUDA kernels, for
    PROFILE_WINDOW_S seconds) the first time it is called with the
    variable set; batchers call it as they collect each batch. Once
    started, a no-op."""
    _PROFILE.tick()
