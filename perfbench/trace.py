"""A torch.profiler window over the device, reduced to what the result
line carries: busy seconds (the union of kernel, copy and set intervals),
the window's length, time and launches by kernel name, the costliest
device operations, and the idle gaps grouped by the host operation that
was running across each gap's middle."""

from __future__ import annotations

import bisect
import gzip
import json
import os
import time
from collections import defaultdict

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, path: str, cuda: bool):
        self.path = path
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.prof.stop()
        self.t1 = time.perf_counter()

    def summary(self) -> dict:
        """Export and reduce the trace: after the window, not inside it."""
        self.prof.export_chrome_trace(self.path)
        out = summarize(self.path, self.t1 - self.t0)
        os.remove(self.path)
        return out


def warm_profiler(cuda: bool) -> None:
    """One short profiler session in set-up: the first session of a
    process has come back without a single device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        x = torch.ones(1024, device="cuda" if cuda else "cpu")
        (x * 2).sum().item()


def profile_window(seconds: float, t0: float, trace_s: float, path: str, cuda: bool,
                   before=None) -> dict:
    """Sleep to a third of the window that started at t0, call `before`
    (the counters' second snapshot), then profile trace_s seconds and
    reduce the trace. A slice that holds no device event is taken again
    while the window has room for it; where none holds one, the metrics
    read from the trace are left out of the line. The per-layer counters come from the
    untraced first third; the device's numbers from the traced slice (the
    profiler slows the host while it records)."""
    time.sleep(max(0.0, t0 + seconds / 3.0 - time.perf_counter()))
    if before is not None:
        before()
    attempts = 0
    while True:
        attempts += 1
        dt = DeviceTrace(path, cuda)
        dt.start()
        time.sleep(trace_s)
        dt.stop()
        out = dt.summary()
        if out["kernels"] or not cuda or time.perf_counter() + trace_s > t0 + seconds:
            out["attempts"] = attempts
            return out


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(path: str, window_s: float) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("name", "")))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev.get("name", "")))
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (e - s) / 1e6
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    # Idle gaps between device work, each named by the innermost host
    # operation running across its middle.
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = defaultdict(float)
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2.0
        best = None
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 4000), -1):
            hs, he, hn = host[j]
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, hn)
        gaps["host: " + (best[2] if best else "no host op")] += (s1 - e0) / 1e6
    top_ops = sorted(((n, v[1]) for n, v in by_name.items()), key=lambda x: -x[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {n: [v[0], v[1]] for n, v in by_name.items()},
            "device_ops": [[n[:160], s] for n, s in top_ops],
            "idle_gaps": [[n[:160], s] for n, s in top_gaps]}
