"""A backlog of documents drained by the program's worker.

Set-up builds the 1M-row store, queues `docs` documents through the
program's queue (`db.queue.enqueue_many`), warms the encoder's batch
buckets at L = 256 and starts `Worker` (microbatches of up to
`worker_max_active` documents: windows, encoder, SQL rows, store adds),
which drains untimed for `settle_s`. The window counts the windows of
every document whose task completed inside it. Lengths are log-normal
(median 1,500 tokens, clipped to 128-16,384) from a fixed draw, put in
the run seed's order; a document is sentences of 15 seeded whole words
and a full stop, one token each."""

from __future__ import annotations

import math
import os
import time

import numpy as np

from ..common import Ctx, counter_delta, device_info, free_runtime, log, rng, sync
from ..corpus import SHAPE_SEED, lognormal_ints
from ..reference import minilm as ref_minilm
from ..stores import COLLECTION, Prepared
from ..trace import profile_window


def n_windows(n_tokens: int, max_length: int = 256, stride: int = 86) -> int:
    content = max_length - 2
    return 1 if n_tokens <= content else 1 + math.ceil((n_tokens - content) / (content - stride))


def window_lengths(n_tokens: int, max_length: int = 256, stride: int = 86) -> list[int]:
    """Tokens of each window, [CLS] and [SEP] included."""
    content = max_length - 2
    step = content - stride
    return [min(content, n_tokens - i * step) + 2 for i in range(n_windows(n_tokens))]


def make_docs(corpus, n: int, spec: dict, seed: int) -> tuple[list[str], np.ndarray]:
    """n documents and their token counts."""
    lens = lognormal_ints(np.random.default_rng(SHAPE_SEED + 2), n, spec)
    g = rng(seed, "docs")
    lens = g.permutation(lens)
    words = corpus.words
    sentences = [" ".join(words[g.integers(0, len(words), 15)]) + "." for _ in range(8192)]
    docs = []
    for t in lens:
        full, rest = divmod(int(t), 16)
        parts = [sentences[i] for i in g.integers(0, len(sentences), full)]
        if rest:
            parts.append(" ".join(words[g.integers(0, len(words), rest)]))
        docs.append(" ".join(parts))
    return docs, lens


def _completed(db) -> set:
    return {r["id"] for r in db.query("SELECT id FROM queue WHERE status = 'Completed'")}


def run(ctx: Ctx) -> dict:
    from memex_tpu_torch.db import queue
    from memex_tpu_torch.metrics import METRICS
    from memex_tpu_torch.worker import Worker

    tr = ctx.traffic
    prep = Prepared(ctx)
    rt = prep.rt
    t = time.perf_counter()
    docs, lens = make_docs(prep.corpus, int(tr["docs"]), tr["doc_tokens"], ctx.seed)
    first = rt.db.query_one("SELECT COALESCE(MAX(id), 0) AS n FROM queue")["n"] + 1
    queue.enqueue_many(rt.db, [(COLLECTION, d, queue.TaskType.Ingest) for d in docs])
    task_of = {first + i: i for i in range(len(docs))}
    log(f"queued {len(docs)} documents ({int(lens.sum())} tokens) in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    max_batch = rt.engine.max_batch
    b = 8
    while b <= max_batch:  # the encoder's batch buckets at L = 256
        rt.engine.encode_batch(["warm up"] * b)
        b *= 2
    sync(ctx.device)
    log(f"warmed the encoder in {time.perf_counter() - t:.2f} s")
    worker = Worker(rt, max_active=rt.settings.worker_max_active)
    worker.start_background()
    time.sleep(float(tr["settle_s"]))

    trace_box: dict = {}
    before = METRICS.snapshot()["counters"]
    done0 = _completed(rt.db)
    t0 = time.perf_counter()
    pre: dict = {}
    if ctx.trace:
        def snap():
            pre.update(t=time.perf_counter(), done=_completed(rt.db))
        trace_box["summary"] = profile_window(
            ctx.seconds, t0, float(tr["trace_s"]), os.path.join(ctx.tmp, "trace.json"),
            ctx.device != "cpu", snap)
    time.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter()))
    done1 = _completed(rt.db)
    t1 = time.perf_counter()
    counters = counter_delta(before, METRICS.snapshot()["counters"])
    setup_s = t0 - ctx.t_start
    window_s = t1 - t0
    left = rt.db.query_one("SELECT COUNT(*) AS n FROM queue WHERE status = 'Queued'")["n"]
    failed = rt.db.query_one("SELECT COUNT(*) AS n FROM queue WHERE status = 'Failed'")["n"]
    worker.shutdown(wait=True)
    dev = device_info(ctx.device)
    in_window = sorted(done1 - done0)
    docs_done = [task_of[i] for i in in_window if i in task_of]
    wl = [n for d in docs_done for n in window_lengths(int(lens[d]))]
    # Per-layer counts: the first third of the window in a traced run.
    wl_pre = [n for i in sorted(pre.get("done", done1) - done0) if i in task_of
              for n in window_lengths(int(lens[task_of[i]]))]
    log(f"window: {len(docs_done)} documents, {len(wl)} windows, {left} still queued")
    readings = _check(ctx, prep, docs, lens, in_window, task_of)
    return {
        "setup_s": setup_s, "window_s": window_s,
        "attempted": len(docs_done) + failed, "failed": failed,
        "e2e": {"ingest_windows_per_s": len(wl) / window_s},
        "obs": {"counters": counters, "window_s": pre.get("t", t1) - t0, "window_tokens": wl_pre,
                "trace": trace_box.get("summary")},
        "device": dev, "trace": trace_box.get("summary"), "readings": readings,
        "notes": {"docs_in_window": len(docs_done), "windows": len(wl), "queued_left": left,
                  "encode_batches": counters.get("batcher.encode.batches", 0),
                  "encode_items": counters.get("batcher.encode.items", 0)},
    }


def _check(ctx: Ctx, prep: Prepared, docs, lens, in_window, task_of) -> dict:
    """A seeded sample of the window's documents and its longest: each
    window's text as stored in SQL against the reference's own cut, and
    each stored vector, read back from the store, against the reference
    embedding of that window."""
    rt, db = prep.rt, prep.rt.db
    g = rng(ctx.seed, "check")
    pick = list(g.choice(in_window, min(len(in_window), int(ctx.traffic["check_docs"])),
                         replace=False)) if in_window else []
    if in_window:
        longest = max(in_window, key=lambda i: lens[task_of[i]])
        pick = sorted(set(pick) | {longest})
    stored = []
    index = prep.store.index
    for task_id in pick:
        doc = db.query_one("SELECT uuid FROM documents WHERE task_id = ?", (int(task_id),))
        rows = db.query("SELECT uuid, segment, content FROM embeddings WHERE document_id = ?"
                        " ORDER BY segment", (doc["uuid"],)) if doc else []
        vecs = []
        for r in rows:
            at = index._id_to_row.get(r["uuid"])
            if at is None:
                vecs.append(None)
                continue
            v = index.buf[at].float() * index.scales[at]
            if index.mean is not None:
                v = v + v.new_tensor(index.mean)
            vecs.append(v.cpu())
        stored.append((task_of[int(task_id)], [r["content"] for r in rows], vecs))
    free_runtime(rt, COLLECTION)
    prep.store = None
    tok = prep.corpus.tok
    mismatch, worst = 0, 0.0
    for d, texts, vecs in stored:
        ref = tok.windows(docs[d])
        mismatch += abs(len(ref) - len(texts))
        mismatch += sum(tok.decode(w) != t for w, t in zip(ref, texts))
        if len(ref) != n_windows(int(lens[d])):
            mismatch += 1
        e = ref_minilm.encode_ids(prep.weights, prep.model_cfg, ref, tok.pad)
        for i, v in enumerate(vecs[: len(ref)]):
            if v is None:
                worst = math.inf
                continue
            v = v.to(e.device)
            worst = max(worst, float(1.0 - (v @ e[i]) / v.norm().clamp_min(1e-12)))
        if len(vecs) < len(ref):
            worst = math.inf
    r = {"window_mismatch": float(mismatch), "worst_vector_gap": worst, "docs": len(stored),
         "windows": sum(len(t) for _, t, _ in stored)}
    log(f"check: {r}")
    return r
