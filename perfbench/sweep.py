"""The knee of an open-loop HTTP cell, found once by a sweep on the card:

    python3 -m perfbench.sweep --workload flat1m_http_steady --rates 200,300,400 \
        [--seconds 15] [--seed 1] [--repeats 1] [--write]

One server child serves every rate in turn, each for `--seconds`, and the
whole ladder `--repeats` times, each pass with the queries in another
seeded order (passes interleave, so a drift of the host spreads over all
rates). For
each rate: p50/p95/p99 from the scheduled send, the share of the window's
searches answered by its end (a backlog that grows leaves it below 1),
and how late the generator sent. The knee is the highest rate whose p95
stays under `--limit-ms` (100: a RAG caller's retrieval budget ahead of
its LLM call) while the window's searches are answered by its end within
one percent, and every lower rate of the pass did so too. Each pass
gives a knee; the sweep reports their range, and `--write` puts 0.8 x the
lowest into the cell's traffic file. Each rate's window follows
`settle_s` of the same open loop, untimed, as a run's does."""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import tempfile
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    from .common import HERE, Ctx, load_json, log, percentile, rng
    from .corpus import Corpus, make_vocab
    from .drivers.open_http import Child, _load, arrivals
    from .run import _env, load_cell

    ap = argparse.ArgumentParser(prog="perfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--limit-ms", type=float, default=100.0)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    _env()
    bench = load_json(os.path.join(os.getcwd(), "BENCHMARK.json"))
    cell, config, traffic = load_cell(bench, args.workload)
    tmp = tempfile.mkdtemp(prefix="perfbench_sweep_", dir=os.environ.get("TMPDIR"))
    ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=args.seed, seconds=args.seconds,
              trace=False, device="cuda", tmp=tmp, t_start=T_START)
    corpus = Corpus(args.seed, config["model"], config["store"], "cpu",
                    make_vocab(config["model"]["vocab_size"]))
    queries = [q for _, q in corpus.queries(int(traffic["pool"]), traffic["query_words"])]
    child = Child(ctx)
    rows = []
    ladder = [(p, float(r)) for p in range(args.repeats) for r in args.rates.split(",")]
    try:
        port = child.read()["port"]
        for rep, rate in ladder:
            order = rng(args.seed, "sweep pass", rep).permutation(len(queries))
            pass_queries = [queries[i] for i in order]
            offsets = arrivals(rate, args.seconds)
            settle = arrivals(rate, float(traffic["settle_s"]))
            out, t0, _ = asyncio.run(_load(port, pass_queries, offsets, int(traffic["k"]),
                                           int(traffic["connections"]),
                                           int(traffic["warm_requests"]), 30.0, child, settle))
            end = child.ask("end")
            c = end["counters"]
            lat = [r[2] - r[0] for r in out]
            late = [r[1] - r[0] for r in out if math.isfinite(r[1])]
            row = {"pass": rep, "rate_qps": rate, "sent": len(out),
                   "answered_by_end": sum(r[2] <= t0 + args.seconds for r in out) / len(out),
                   "failed": sum(not math.isfinite(x) for x in lat),
                   "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
                   "p99_ms": 1e3 * percentile(lat, 99),
                   "late_p99_ms": 1e3 * percentile(late, 99),
                   "batch_fill": c.get("batcher.search.items", 0)
                   / max(1, c.get("batcher.search.batches", 0))}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        child.close()
    knees = []
    for rep in range(args.repeats):
        knee = None
        for r in sorted((r for r in rows if r["pass"] == rep), key=lambda r: r["rate_qps"]):
            if r["p95_ms"] >= args.limit_ms or r["answered_by_end"] < 0.99 or r["failed"]:
                break  # the knee is the last rate before the pass's first miss
            knee = r["rate_qps"]
        knees.append(knee)
    knee = None if None in knees else min(knees)
    print(json.dumps({"knees_qps": knees, "knee_qps": knee, "limit_ms": args.limit_ms,
                      "cell_rate_qps": None if knee is None else 0.8 * knee}), flush=True)
    if args.write and knee is not None:
        path = os.path.join(HERE, "traffic", cell["traffic"] + ".json")
        spec = load_json(path)
        spec["rate_qps"] = round(0.8 * knee, 1)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(spec, fh, indent=1)
        log(f"wrote rate_qps {spec['rate_qps']} into {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
