"""Long-document JSON extraction through the local LLM: one closed-loop
client running the ask handler's `work()` body (`api/server.py`
`action_ask`: `llm.truncate_text`, `prompter.json_schema_extraction`,
`llm.chat_completion`) back to back.

Set-up writes the model's config.json and a LOCAL_LLM_CONFIG TOML, loads
the program's LLM through `LocalLLM.from_config`, its loader reading the
weights the harness draws from the run's seed (`llm_check.DrawnWeights`,
by HF's names, as from a checkpoint in memory), and warms every prompt
bucket the traffic reaches. Each document is asked `asks_per_doc`
different asks in a row, `answer_tokens` ids each, greedy. An ask counts
when it completes inside the window; the window's counters (the
program's `llm.*` spans and device times) are its completed asks'. No
profiler is attached to the process in the window, traced or not. With
--trace 1 the main thread then profiles one bounded slice after the
window, on its own: the next ask with `trace_answer_tokens` ids (one
prefill and a chunk of decode steps), the device's activity alone
(`KernelTrace`); its counters are kept apart, to say what the profiler
costs. The check (llm_check.py) then replays a seeded sample of the
window's asks and holds them to the reference; its recall@10 of the
next id against the reference is the cell's `recall_at_10`.

The family is imported here, where the module loads: a program without
DeepSeek-V2 fails at once, before any set-up, with no result line."""

from __future__ import annotations

import os
import threading
import time

from memex_tpu_torch.llm.local import deepseek_v2  # where the module loads: see above

from .. import llm_check
from ..check import sample_of
from ..common import Ctx, counter_delta, device_info, log, rng, sync
from ..trace import DeviceTrace, warm_profiler


class KernelTrace(DeviceTrace):
    """A DeviceTrace of the device's activity alone (the host's on the
    CPU, which has no device): recording every host op as well slowed a
    profiled ask of this launch-bound loop about tenfold (5 s to 41-57 s,
    NVIDIA H100 80GB HBM3)."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.perf_counter()


def load_llm(ctx: Ctx, weights):
    """The program's LLM, loaded from the run's TOML and `weights`."""
    from memex_tpu_torch.llm.local.runtime import LocalLLM

    toml = llm_check.write_model(ctx.config, ctx.tmp)
    llm = LocalLLM.from_config(toml, device=ctx.device, weights=weights)
    if not isinstance(llm.cfg, deepseek_v2.DeepseekV2Config):
        raise SystemExit(f"perfbench: the runtime's LLM is {type(llm.cfg).__name__}, "
                         "not DeepSeek-V2")
    return llm


def drawn_weights(ctx: Ctx) -> "llm_check.DrawnWeights":
    return llm_check.DrawnWeights(llm_check.hf_config(ctx.config), ctx.seed, ctx.device,
                                  ctx.config["param_dtype"])


def work(llm, prompter, text: str, query: str, schema: dict, max_new: int) -> str:
    """The ask handler's `work()` body, with the cell's answer length."""
    content, model = llm.truncate_text(text)
    prompt = prompter.json_schema_extraction(content, query, schema)
    return llm.chat_completion(model, prompt, max_new=max_new)


def decode_ms_per_tok(counters: dict) -> float | None:
    n = counters.get("llm.decode_tokens", 0)
    return counters.get("llm.decode_dev_us", 0) / 1e3 / n if n else None


def run(ctx: Ctx) -> dict:
    from memex_tpu_torch.llm import prompter
    from memex_tpu_torch.llm.local.runtime import prompt_buckets, render_chat
    from memex_tpu_torch.metrics import METRICS

    tr = ctx.traffic
    answer = int(tr["answer_tokens"])
    t = time.perf_counter()
    weights = drawn_weights(ctx)
    llm = load_llm(ctx, weights)
    sync(ctx.device)
    log(f"program LLM {llm.default_model} ({llm.cfg.num_layers} layers, "
        f"{llm.cfg.n_routed_experts} experts) loaded in {time.perf_counter() - t:.2f} s")
    over = llm_check.overhead_ids(llm, prompter, render_chat)
    docs = llm_check.make_docs(tr, ctx.seed, over)
    asks = llm_check.make_asks(tr, ctx.seed, len(docs))
    # Warm-up: one ask at every bucket the traffic's prompts reach (a
    # decode step has one shape at every position: a few steps warm it).
    t = time.perf_counter()
    lo, hi = int(tr["prompt_ids"]["min"]), int(tr["prompt_ids"]["max"])
    tops = [b for b in prompt_buckets(llm.cfg.max_context) if b >= lo] + [hi]
    lens = sorted({max(lo, min(hi, b)) for b in tops})
    for n in lens:
        work(llm, prompter, "w" * (n - over), *llm_check.ASKS[0], max_new=min(4, answer))
    sync(ctx.device)
    log(f"warmed prompts of {lens} ids in {time.perf_counter() - t:.2f} s")

    done: list = []   # (ask index, emitted ids, prompt ids, seconds)
    failed = [0]
    asked = [0]       # asks the client began
    stop = threading.Event()
    start = threading.Event()
    t_end = [float("inf")]

    def client() -> None:
        start.wait()
        i = 0
        while not stop.is_set() and i < len(asks):
            d, a = asks[i]
            t_ask = time.perf_counter()
            asked[0] = i + 1
            try:
                work(llm, prompter, docs[d], *llm_check.ASKS[a], max_new=answer)
            except Exception as exc:  # an ask that fails counts, the loop goes on
                log(f"ask {i} failed: {exc!r}")
                if time.perf_counter() <= t_end[0]:
                    failed[0] += 1
                i += 1
                continue
            t_done = time.perf_counter()
            if t_done <= t_end[0]:
                c = llm.last_completion
                done.append((i, list(c["ids"]), c["prompt_ids"], t_done - t_ask))
            i += 1

    thread = threading.Thread(target=client, name="perfbench-ask", daemon=True)
    thread.start()
    before = METRICS.snapshot()["counters"]
    t0 = time.perf_counter()
    t_end[0] = t0 + ctx.seconds
    start.set()
    time.sleep(max(0.0, t_end[0] - time.perf_counter()))
    counters = counter_delta(before, METRICS.snapshot()["counters"])
    t1 = time.perf_counter()
    stop.set()
    thread.join()
    if len(done) + failed[0] >= len(asks):
        raise SystemExit("perfbench: the traffic ran out of asks inside the window")
    trace, traced = None, {}
    if ctx.trace:
        # One bounded slice after the window, on this thread alone: the
        # window's asks ran with no profiler attached.
        warm_profiler(ctx.device != "cpu")
        d, a = asks[min(asked[0], len(asks) - 1)]
        session = KernelTrace(os.path.join(ctx.tmp, "trace.json"), ctx.device != "cpu")
        snap = METRICS.snapshot()["counters"]
        session.start()
        work(llm, prompter, docs[d], *llm_check.ASKS[a], max_new=int(tr["trace_answer_tokens"]))
        sync(ctx.device)
        session.stop()
        traced = counter_delta(snap, METRICS.snapshot()["counters"])
        trace = session.summary()
    dev = device_info(ctx.device)
    setup_s = t0 - ctx.t_start
    window_s = t1 - t0
    log(f"window: {len(done)} asks, {failed[0]} failed, "
        f"{sum(len(x[1]) for x in done)} answer ids, "
        f"prompts {[x[2] for x in done]} ids")
    samples = []
    for i, ids, _, _ in sample_of(done, int(tr["check_asks"]), rng(ctx.seed, "check")):
        d, a = asks[i]
        content, _ = llm.truncate_text(docs[d])
        samples.append((llm_check.messages(prompter, content, a), ids))
    readings = llm_check.readings(llm_check.hf_config(ctx.config), weights.get, llm, samples)
    notes = {"asks": len(done), "answer_ids": sum(len(x[1]) for x in done),
             "prompt_ids": [x[2] for x in done],
             "ask_s": [round(x[3], 4) for x in done],
             "prefill_dev_ms": counters.get("llm.prefill_dev_us", 0) / 1e3,
             "decode_dev_ms": counters.get("llm.decode_dev_us", 0) / 1e3,
             "moe_dev_ms": counters.get("llm.moe_dev_us", 0) / 1e3,
             "decode_ms_per_tok": decode_ms_per_tok(counters)}
    if trace is not None:
        # What the attached profiler costs: the profiled slice's own
        # device times beside the window's.
        notes.update({"traced_slice_s": trace["window_s"],
                      "traced_prompt_ids": traced.get("llm.prompt_tokens", 0),
                      "traced_prefill_dev_ms": traced.get("llm.prefill_dev_us", 0) / 1e3,
                      "traced_decode_ms_per_tok": decode_ms_per_tok(traced)})
    return {
        "setup_s": setup_s, "window_s": window_s,
        "attempted": len(done) + failed[0], "failed": failed[0],
        "e2e": {"recall_at_10": readings["recall_at_10"]},
        "obs": {"counters": counters, "window_s": window_s, "trace": trace,
                "asks": [[x[2], answer] for x in done]},
        "device": dev, "trace": trace, "readings": readings, "notes": notes,
    }
