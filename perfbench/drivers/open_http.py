"""Open loop over HTTP: searches sent to `POST /api/collections/{c}/search`
at Poisson arrival times of a fixed rate, whether or not earlier ones
have returned.

The server runs in a child process (`http_server.py`); this process only
generates load, with asyncio and keep-alive connections, and never
touches the card. Each search is timed from its scheduled send time to
its full response; one that fails, is refused or has not returned
`drain_s` after the window counts as missing every limit. The arrival
gaps are a fixed draw of `rate_qps x seconds` exponential gaps scaled to
the window, the same pattern in every run; the queries are the seed's."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from ..common import ROOT, Ctx, log, percentile, rng
from ..corpus import SHAPE_SEED, Corpus, make_vocab
from ..check import sample_of
from ..stores import COLLECTION
from .http_server import REPLY


class Child:
    """The server process and its command pipe."""

    def __init__(self, ctx: Ctx):
        spec = dataclasses.asdict(ctx)
        spec.pop("t_start")
        path = os.path.join(ctx.tmp, "run.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(spec, fh)
        self.proc = subprocess.Popen([sys.executable, "-m", "perfbench.drivers.http_server", path],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                     cwd=ROOT, bufsize=1)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
        raise RuntimeError(f"the server child ended (exit {self.proc.wait()})")

    def ask(self, cmd: str, **kw) -> dict:
        self.proc.stdin.write(json.dumps({"cmd": cmd, **kw}) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """Send offsets in [0, seconds): one fixed draw of exponential gaps,
    the same in every run (the seed draws the queries, not the arrival
    pattern, whose bursts alone moved p95 by a fifth between seeds),
    scaled so the span holds exactly rate x seconds searches, one every
    seconds / n on average (the next span starts seconds after this one)."""
    n = max(2, int(round(rate * seconds)))
    gaps = np.random.default_rng(SHAPE_SEED + 3).exponential(1.0, n)
    t = np.cumsum(gaps) - gaps[0]
    return t * (seconds * (n - 1) / n) / max(t[-1], 1e-12)


async def _load(port: int, queries: list[str], offsets: np.ndarray, k: int, conns: int,
                warm: int, drain_s: float, child: Child,
                settle: np.ndarray | None = None) -> tuple[list, float, float]:
    """Warm the HTTP path, send the `settle` schedule (set-up: the same
    open loop, untimed, so the window starts in a steady state), then the
    window's; the child is told the window started as its first search is
    due. Returns (per search (due, sent, done, hits), t0 loop, t0 perf)."""
    import aiohttp

    url = f"http://127.0.0.1:{port}/api/collections/{COLLECTION}/search"
    out: list = [None] * len(offsets)
    loop = asyncio.get_running_loop()
    conn = aiohttp.TCPConnector(limit=conns, force_close=False)
    timeout = aiohttp.ClientTimeout(total=None)
    async with aiohttp.ClientSession(connector=conn, timeout=timeout) as session:

        async def one(q: str):
            async with session.post(url, json={"query": q, "limit": k}) as r:
                body = await r.json()
                if r.status != 200:
                    raise RuntimeError(f"HTTP {r.status}")
                return body["result"]["results"]

        # Set-up: the HTTP path warm, connections open.
        sem = asyncio.Semaphore(32)

        async def warm_one(q):
            async with sem:
                await one(q)

        await asyncio.gather(*(warm_one(queries[i % len(queries)]) for i in range(warm)))

        async def timed(i: int, due: float):
            sent = loop.time()
            try:
                res = await one(queries[i % len(queries)])
                out[i] = (due, sent, loop.time(), [(h["_id"], h["document_id"]) for h in res])
            except Exception as exc:  # noqa: BLE001 -- a failure is counted, not raised
                out[i] = (due, sent, math.inf, repr(exc))

        async def quiet(q: str):
            try:
                await one(q)
            except Exception:  # noqa: BLE001 -- set-up traffic: not counted
                pass

        settle = np.zeros(0) if settle is None else settle
        start = loop.time()
        settling = []
        for j, off in enumerate(settle):
            delay = start + float(off) - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            settling.append(asyncio.create_task(quiet(queries[-1 - j % len(queries)])))
        if len(settle):  # the window starts one mean gap after the last settle send
            span = float(settle[-1]) * len(settle) / (len(settle) - 1)
            await asyncio.sleep(max(0.0, start + span - loop.time()))
        marked = loop.run_in_executor(None, child.ask, "mark")
        t0, t0_pc = loop.time(), time.perf_counter()
        tasks = []
        for i, off in enumerate(offsets):
            due = t0 + float(off)
            delay = due - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.create_task(timed(i, due)))
        end = t0 + float(offsets[-1])
        _, pending = await asyncio.wait(tasks, timeout=max(1.0, end + drain_s - loop.time()))
        for p in pending:
            p.cancel()
        await marked
        await asyncio.gather(*settling)
        for i in range(len(out)):
            if out[i] is None:
                out[i] = (t0 + float(offsets[i]), math.nan, math.inf, "no reply")
    return out, t0, t0_pc


def run(ctx: Ctx) -> dict:
    tr = ctx.traffic
    k = int(tr["k"])
    cfg = ctx.config
    corpus = Corpus(ctx.seed, cfg["model"], cfg["store"], "cpu", make_vocab(cfg["model"]["vocab_size"]))
    queries = [q for _, q in corpus.queries(int(tr["pool"]), tr["query_words"])]
    offsets = arrivals(float(tr["rate_qps"]), ctx.seconds)
    order = rng(ctx.seed, "http order").permutation(len(queries))
    queries = [queries[i] for i in order]
    child = Child(ctx)
    try:
        ready = child.read()
        log(f"server child ready on port {ready['port']}")
        settle = arrivals(float(tr["rate_qps"]), float(tr["settle_s"]))
        out, t0, t0_pc = asyncio.run(_load(ready["port"], queries, offsets, k, int(tr["connections"]),
                                           int(tr["warm_requests"]), float(tr["drain_s"]), child,
                                           settle))
        end = child.ask("end")
        ok = [(queries[i % len(queries)], r[3]) for i, r in enumerate(out)
              if math.isfinite(r[2])]
        sample = sample_of(ok, int(tr["check_sample"]), rng(ctx.seed, "check"))
        hyd = sum(doc != "d" + sid[1:] for _, hits in sample for sid, doc in hits)
        got = child.ask("check", sample=[(q, [sid for sid, _ in hits]) for q, hits in sample])
    finally:
        child.close()
    lat = [r[2] - r[0] for r in out]
    late = [r[1] - r[0] for r in out if math.isfinite(r[1])]
    failed = sum(not math.isfinite(x) for x in lat)
    # A search that never answered counts at the tail. Between runs on one
    # host p50 and p95 spread past any allowed bound, so the median is a
    # per-layer reading (`search_p50_ms.http`), not an end-to-end metric,
    # taken over the searches due in the window's first third: the span the
    # counters cover, before a traced run's profiler slows the server.
    p50, p95 = (percentile(lat, q) for q in (50, 95))
    first = percentile([x for x, off in zip(lat, offsets) if off < ctx.seconds / 3.0], 50)
    p50, first = (x if math.isfinite(x) else float(tr["drain_s"]) + ctx.seconds
                  for x in (p50, first))
    log(f"generator lateness: median {1e3 * float(np.median(late)):.3f} ms, p99 "
        f"{1e3 * percentile(late, 99):.3f} ms, max {1e3 * max(late):.3f} ms; "
        f"latency p50 {1e3 * p50:.2f} ms, p95 {1e3 * p95:.2f} ms, "
        f"p99 {1e3 * percentile(lat, 99):.2f} ms; completed {len(out) - failed}/{len(out)}")
    done_by_end = sum(r[2] <= t0 + ctx.seconds for r in out)
    readings = dict(got["readings"], hydration_mismatch=float(hyd))
    return {
        "setup_s": t0_pc - ctx.t_start, "window_s": ctx.seconds,
        "attempted": len(out), "failed": failed,
        "e2e": {"recall_at_10": readings["recall_at_10"]},
        "obs": {"counters": end["counters"], "trace": end["trace"], "search_p50_ms": 1e3 * first},
        "device": end["device"], "trace": end["trace"], "readings": readings,
        "child_forbidden": got.get("forbidden"),
        "notes": {"own_topic_share": end["own_topic_share"], "completed_in_window": done_by_end,
                  "lateness_p99_ms": 1e3 * percentile(late, 99), "latency_p95_ms": 1e3 * p95,
                  "latency_p99_ms": 1e3 * percentile(lat, 99)},
    }
