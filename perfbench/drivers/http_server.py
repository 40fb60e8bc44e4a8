"""The server side of `open_http`, run as a child process so the load
generator does not share its interpreter lock:

    python3 -m perfbench.drivers.http_server <run.json>

Builds the store and its SQL rows from the seed, warms the traffic's
shapes, serves the program's aiohttp app (`api/server.py::start_async`)
on a free localhost port, then answers the parent's commands, one JSON
object a line on stdin, each reply a line on stdout starting with
REPLY: `mark` (the window starts: snapshot the counters; with a trace,
profile `trace_s` a third into the window), `end` (counter deltas, the
trace, the device's memory peak), `check` (stop serving, free the
program's state, judge the sample against the reference), `exit`."""

from __future__ import annotations

import asyncio
import json
import os
import socket
import sys
import threading
import time

from ..common import Ctx, counter_delta, device_info, forbidden_modules, load_json, log
from ..stores import Prepared
from ..trace import profile_window
from . import search_common

REPLY = "@@perfbench "


def _reply(obj: dict) -> None:
    sys.stdout.write(REPLY + json.dumps(obj, default=float) + "\n")
    sys.stdout.flush()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(path: str) -> int:
    spec = load_json(path)
    ctx = Ctx(**spec, t_start=time.perf_counter())
    from memex_tpu_torch.api.server import start_async
    from memex_tpu_torch.metrics import METRICS

    tr = ctx.traffic
    k = int(tr["k"])
    prep = Prepared(ctx)
    prep.fill_sql()
    pool = prep.corpus.queries(int(tr["pool"]), tr["query_words"])
    n = search_common.warm(prep, k, max(len(t.split()) for _, t in pool) + 2)
    log(f"server: warmed {n} shapes")
    rt = prep.rt
    rt.settings.host, rt.settings.port = "127.0.0.1", _free_port()
    box: dict = {}
    ready = threading.Event()

    def serve() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        box["loop"], box["ev"] = loop, asyncio.Event()
        ready.set()
        try:
            loop.run_until_complete(start_async(rt, box["ev"]))
        finally:
            loop.close()

    server = threading.Thread(target=serve, name="perfbench-server", daemon=True)
    server.start()
    ready.wait(30)
    _reply({"ready": True, "port": rt.settings.port})
    before, pre, summary = {}, None, None
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "mark":
            before = METRICS.snapshot()["counters"]
            _reply({"marked": True})
            if ctx.trace:
                def snap():
                    nonlocal pre
                    pre = METRICS.snapshot()["counters"]
                summary = profile_window(ctx.seconds, time.perf_counter(), float(tr["trace_s"]),
                                         os.path.join(ctx.tmp, "trace.json"),
                                         ctx.device != "cpu", snap)
        elif cmd["cmd"] == "end":
            # Per-layer counts: the first third of the window in a traced run.
            counters = counter_delta(before, pre or METRICS.snapshot()["counters"])
            _reply({"counters": counters, "trace": summary,
                    "device": device_info(ctx.device),
                    "own_topic_share": search_common.own_topic_share(prep, pool)})
        elif cmd["cmd"] == "check":
            box["loop"].call_soon_threadsafe(box["ev"].set)
            server.join(timeout=30)
            sample = [(q, ids) for q, ids in cmd["sample"]]
            readings = search_common.check(ctx, prep, sample, k)
            _reply({"readings": readings, "forbidden": forbidden_modules()})
        elif cmd["cmd"] == "exit":
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
