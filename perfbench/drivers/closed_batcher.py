"""Closed loop through the search batcher: `clients` virtual clients, each
sending its next query as soon as its last one returns.

A client is a chain of completion callbacks on the batcher's own futures
(`SearchBatcher._mb.submit`, the call `SearchBatcher.search` blocks on),
so the load adds no thread to contend with the program's for the
interpreter lock: one process, few threads. Set-up builds the store,
warms the traffic's shapes and runs the loop for `settle_s` untimed; the
window then runs `--seconds`. A search counts when it completes inside
the window. With --trace 1 the profiler covers `trace_s` seconds from a
third into the window."""

from __future__ import annotations

import os
import threading
import time

from ..common import Ctx, counter_delta, device_info, log
from ..stores import COLLECTION, Prepared
from ..trace import profile_window
from . import search_common


def _loop(rt, pool, clients: int, seconds: float, k: int, record: bool,
          on_start=None) -> tuple[list, float, float, int]:
    """Run the closed loop; (completed [(pool index, ids, t)], t0, t1, failed)."""
    mb = rt.search_batcher._mb
    done: list = []
    failed = [0]
    lock = threading.Lock()
    left = [clients]
    finished = threading.Event()
    t_end = [float("inf")]

    def send(i: int) -> None:
        fut = mb.submit((COLLECTION, pool[i % len(pool)][1], k))
        fut.add_done_callback(lambda f: landed(i, f))

    def landed(i: int, fut) -> None:
        t = time.perf_counter()
        err = fut.exception()
        if t <= t_end[0]:
            with lock:
                if err is not None:
                    failed[0] += 1
                elif record:
                    done.append((i % len(pool), [h.id for h in fut.result()], t))
        if t < t_end[0]:
            send(i + clients)
            return
        with lock:
            left[0] -= 1
            if left[0] == 0:
                finished.set()

    t0 = time.perf_counter()
    t_end[0] = t0 + seconds
    for c in range(clients):
        send(c)
    if on_start is not None:
        on_start(t0)
    if not finished.wait(timeout=seconds + 300):
        raise RuntimeError("searches still outstanding 300 s after the window")
    return done, t0, t_end[0], failed[0]


def run(ctx: Ctx) -> dict:
    from memex_tpu_torch.metrics import METRICS

    tr = ctx.traffic
    k = int(tr["k"])
    prep = Prepared(ctx)
    pool = prep.corpus.queries(int(tr["pool"]), tr["query_words"])
    max_tokens = max(len(t.split()) for _, t in pool) + 2
    t = time.perf_counter()
    n_warm = search_common.warm(prep, k, max_tokens)
    log(f"warmed {n_warm} shapes in {time.perf_counter() - t:.2f} s")
    _loop(prep.rt, pool, int(tr["clients"]), float(tr["settle_s"]), k, record=False)

    trace_box: dict = {}
    probed = search_common.ProbedRows(prep) if ctx.trace else None

    def traced(t0: float) -> None:
        """The profiler runs on the main thread, a third into the window."""
        if ctx.trace:
            if probed is not None:
                probed.on = True

            def snap():
                trace_box["pre"] = METRICS.snapshot()["counters"]
                if probed is not None:
                    probed.on = False
            trace_box["summary"] = profile_window(
                ctx.seconds, t0, float(tr["trace_s"]), os.path.join(ctx.tmp, "trace.json"),
                ctx.device != "cpu", snap)

    before = METRICS.snapshot()["counters"]
    done, t0, t1, failed = _loop(prep.rt, pool, int(tr["clients"]), ctx.seconds, k,
                                 record=True, on_start=traced)
    counters = counter_delta(before, METRICS.snapshot()["counters"])
    setup_s = t0 - ctx.t_start
    window_s = t1 - t0
    dev = device_info(ctx.device)
    # Per-layer counts: the window's untraced first third in a traced run.
    layer_counters = counter_delta(before, trace_box["pre"]) if "pre" in trace_box else counters
    obs = {"counters": layer_counters, "trace": trace_box.get("summary"),
           "probed_rows": probed.close() if probed is not None else []}
    union = search_common.ivf_union(prep, [q for _, q in pool])
    topic_share = search_common.own_topic_share(prep, pool)
    completed = [(pool[i][1], ids) for i, ids, _ in done]
    readings = search_common.check(ctx, prep, completed, k)
    return {
        "setup_s": setup_s, "window_s": window_s,
        "attempted": len(done) + failed, "failed": failed,
        "e2e": {"recall_at_10": readings["recall_at_10"]},
        "obs": obs,
        "device": dev, "trace": trace_box.get("summary"),
        "readings": readings,
        # Searches a second are not a metric: between runs on one host they
        # spread beyond any bound the benchmark may set (PERF.md).
        "notes": {"search_qps": len(done) / window_s, "own_topic_share": topic_share,
                  "union": union, "batches": counters.get("batcher.search.batches", 0),
                  "items": counters.get("batcher.search.items", 0)},
    }
