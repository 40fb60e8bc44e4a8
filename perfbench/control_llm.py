"""The controls of the local-LLM cell: the program made wrong on purpose,
read on the cell's own inputs by the cell's own comparison. The
benchmark's runs never run this.

    python3 -m perfbench.control_llm --workload dsv2lite_extract_long \
        --seeds 11,12,13 --control fp8|top5 [--device cpu]

  - fp8: the program loads the attention, dense and expert weights
    (routed and shared) rounded through float8_e4m3fn with a scale a
    matrix (amax / 448), one step below the bf16 the configuration
    states;
  - top5: the program's router keeps 5 experts a token instead of 6.

For each seed the program, so altered, answers the first asks of the
cell's seeded order (`check_asks` of the first six) through the ask
handler's body; its logits and MoE layers are replayed as the cell's
check replays them and compared with the reference on the harness's
own, unaltered draw of the weights. Prints one JSON line a seed: the
readings and the verdict `run.judge` gives them under the cell's limits
(`correct`, which has to come out false)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile

import torch

CONTROLS = ("fp8", "top5")
# The HF names the fp8 control rounds: every matmul weight but the router,
# the embedding and the head.
_FP8 = ("_proj.weight", "_proj_with_mqa.weight")


class Fp8Rounded:
    """`weights` with each matrix named in _FP8 rounded through
    float8_e4m3fn, one scale a matrix."""

    def __init__(self, weights):
        self.weights = weights

    def get(self, name: str) -> torch.Tensor:
        w = self.weights.get(name)
        if not name.endswith(_FP8):
            return w
        s = w.abs().amax().float().clamp_min(1e-12) / 448.0
        return ((w.float() / s).to(torch.float8_e4m3fn).float() * s).to(w.dtype)


def control(ctx, kind: str) -> dict:
    """The readings of the altered program on the cell's inputs."""
    from memex_tpu_torch.llm import prompter
    from memex_tpu_torch.llm.local.runtime import render_chat

    from . import llm_check
    from .check import sample_of
    from .common import rng
    from .drivers.llm_ask import drawn_weights, load_llm, work

    if kind not in CONTROLS:
        raise ValueError(f"unknown control {kind!r}; known: {CONTROLS}")
    tr = ctx.traffic
    weights = drawn_weights(ctx)
    llm = load_llm(ctx, Fp8Rounded(weights) if kind == "fp8" else weights)
    if kind == "top5":
        llm.cfg = dataclasses.replace(llm.cfg, num_experts_per_tok=5)
    docs = llm_check.make_docs(tr, ctx.seed, llm_check.overhead_ids(llm, prompter, render_chat))
    asks = llm_check.make_asks(tr, ctx.seed, len(docs))
    samples = []
    for d, a in sample_of(asks[:6], int(tr["check_asks"]), rng(ctx.seed, "check")):
        work(llm, prompter, docs[d], *llm_check.ASKS[a], max_new=int(tr["answer_tokens"]))
        content, _ = llm.truncate_text(docs[d])
        samples.append((llm_check.messages(prompter, content, a),
                        list(llm.last_completion["ids"])))
    return llm_check.readings(llm_check.hf_config(ctx.config), weights.get, llm, samples)


def main(argv=None) -> int:
    from .common import Ctx, load_json
    from .run import _env, _merge, judge, load_cell

    ap = argparse.ArgumentParser(prog="perfbench.control_llm")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=CONTROLS, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _env()
    bench = load_json(os.path.join(os.getcwd(), "BENCHMARK.json"))
    cell, config, traffic = load_cell(bench, args.workload)
    if args.device == "cpu":
        config = _merge(config, config.get("rehearsal", {}))
        traffic = _merge(traffic, traffic.get("rehearsal", {}))
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="perfbench_control_") as tmp:
            ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=seed, seconds=0.0,
                      trace=False, device=args.device, tmp=tmp, t_start=0.0)
            r = control(ctx, args.control)
        correct, checks = judge(r, traffic["limits"])
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "correct": correct, "readings": r, "checks": checks},
                         default=lambda x: str(x) if not math.isfinite(x) else x), flush=True)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
