"""The controls: the reference put in the program's place one precision
step below what the configuration states (int4 rows for its int8 rows),
read on the cell's own inputs. The benchmark's runs never run this.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13 [--device cpu]

prints one JSON line a seed: the numbers that cell compares, and the
verdict `run.judge` gives them under the cell's limits (`correct`, which
has to come out false). A search cell's control answers a seeded sample
of the cell's queries (`check_sample`, from the same pool the window
draws) with its top k over int4 rows, judged by the same comparison as
the program's answers (its ids name their rows, so it hydrates nothing
wrong); the ingest cell's embeds the sampled documents' windows and
stores them as int4 rows."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np


def search_control(ctx) -> dict:
    from .check import control_ids, sample_of, search_readings
    from .common import rng
    from .corpus import Corpus, content_seed, make_vocab, make_weights

    cfg = ctx.config["model"]
    weights = make_weights(cfg, content_seed(ctx.config["store"], ctx.seed), ctx.device)
    corpus = Corpus(ctx.seed, cfg, ctx.config["store"], ctx.device, make_vocab(cfg["vocab_size"]))
    corpus.embed_centres(weights)
    pool = corpus.queries(int(ctx.traffic["pool"]), ctx.traffic["query_words"])
    texts = [q for q, _ in sample_of([(q, None) for _, q in pool],
                                     int(ctx.traffic["check_sample"]), rng(ctx.seed, "check"))]
    k = int(ctx.traffic["k"])
    ids = control_ids(corpus, weights, cfg, texts, k)
    readings = search_readings(corpus, weights, cfg, list(zip(texts, ids)), k)
    if "hydration_mismatch" in ctx.traffic["limits"]:
        readings["hydration_mismatch"] = 0.0
    return readings


def ingest_control(ctx) -> dict:
    from .check import _quant_int4
    from .corpus import Corpus, content_seed, make_vocab, make_weights
    from .drivers.ingest_backlog import make_docs
    from .reference import minilm as ref_minilm

    cfg = ctx.config["model"]
    corpus = Corpus(ctx.seed, cfg, ctx.config["store"], ctx.device, make_vocab(cfg["vocab_size"]))
    weights = make_weights(cfg, content_seed(ctx.config["store"], ctx.seed), ctx.device)
    n = int(ctx.traffic["check_docs"]) + 1
    docs, lens = make_docs(corpus, int(ctx.traffic["docs"]), ctx.traffic["doc_tokens"], ctx.seed)
    pick = list(np.argsort(-lens)[:1]) + list(range(n - 1))
    worst = 0.0
    for d in pick:
        wins = corpus.tok.windows(docs[d])
        e = ref_minilm.encode_ids(weights, cfg, wins, corpus.tok.pad)
        q = _quant_int4(e)
        worst = max(worst, float((1.0 - (q * e).sum(1) / q.norm(dim=1)).max()))
    return {"window_mismatch": 0.0, "worst_vector_gap": worst, "docs": len(pick)}


def main(argv=None) -> int:
    from .common import Ctx, load_json
    from .run import _merge, judge, load_cell

    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(os.getcwd(), "BENCHMARK.json"))
    cell, config, traffic = load_cell(bench, args.workload)
    if args.device == "cpu":
        config = _merge(config, config.get("rehearsal", {}))
        traffic = _merge(traffic, traffic.get("rehearsal", {}))
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=seed, seconds=0.0,
                  trace=False, device=args.device, tmp=tempfile.gettempdir(), t_start=0.0)
        fn = ingest_control if traffic["kind"] == "ingest_backlog" else search_control
        r = fn(ctx)
        correct, checks = judge(r, traffic["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "control": r, "checks": checks},
                         default=lambda x: str(x) if not math.isfinite(x) else x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
