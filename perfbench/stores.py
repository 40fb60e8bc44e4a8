"""Set-up shared by the drivers: the checkpoint the program loads, the
corpus, the program's runtime, and the store filled with the corpus's
rows (built here, with the program's own bulk paths)."""

from __future__ import annotations

import os
import time

import torch

from .common import Ctx, log, make_runtime, sync
from .corpus import Corpus, content_seed, make_vocab, make_weights, write_checkpoint
from .trace import warm_profiler

COLLECTION = "bench"


class Prepared:
    """The run's inputs and the program's runtime over its store."""

    def __init__(self, ctx: Ctx):
        t = time.perf_counter()
        self.ctx = ctx
        self.model_cfg = ctx.config["model"]
        self.vocab = make_vocab(self.model_cfg["vocab_size"])
        self.weights = make_weights(self.model_cfg, content_seed(ctx.config["store"], ctx.seed),
                                    ctx.device)
        self.model_dir = os.path.join(ctx.tmp, "model")
        write_checkpoint(self.model_dir, self.model_cfg, self.weights, self.vocab)
        self.corpus = Corpus(ctx.seed, self.model_cfg, ctx.config["store"], ctx.device,
                             self.vocab)
        self.corpus.embed_centres(self.weights)
        sync(ctx.device)
        log(f"inputs: vocab, weights, checkpoint, {self.corpus.n_topics} topic centres "
            f"in {time.perf_counter() - t:.2f} s")
        if ctx.trace:
            warm_profiler(ctx.device != "cpu")
        self.rt = make_runtime(ctx, self.model_dir)
        t = time.perf_counter()
        _ = self.rt.engine  # loads the checkpoint through load_params
        log(f"program encoder loaded in {time.perf_counter() - t:.2f} s")
        self.store = self.rt.store(COLLECTION)
        t = time.perf_counter()
        self._fill()
        sync(ctx.device)
        log(f"store: {self.store.count} rows in {time.perf_counter() - t:.2f} s")

    def _fill(self) -> None:
        from memex_tpu_torch.ops.fused_topk import quantize_rows_int8

        c, index = self.corpus, self.store.index
        kind = self.ctx.config["store"]["kind"]
        if kind == "flat":
            for b in range(c.n_blocks):
                v, _ = c.block(b)
                codes, scales = quantize_rows_int8(v)
                lo = b * c.BLOCK
                index.add_quantized(codes, scales, c.row_ids(lo, lo + v.shape[0]))
            return
        if kind != "ivf":
            raise ValueError(f"unknown store kind {kind!r}")
        codes = torch.empty((c.n_rows, c.dim), dtype=torch.int8, device=c.device)
        scales = torch.empty((c.n_rows,), dtype=torch.float32, device=c.device)
        for b in range(c.n_blocks):
            v, _ = c.block(b)
            lo = b * c.BLOCK
            codes[lo : lo + v.shape[0]], scales[lo : lo + v.shape[0]] = quantize_rows_int8(v)
            del v
        t = time.perf_counter()
        index.build_device(codes, scales, c.row_ids(0, c.n_rows))
        sync(self.ctx.device)
        log(f"ivf device build {time.perf_counter() - t:.2f} s, spill {index.spill.count}")

    def fill_sql(self) -> None:
        """One `embeddings` row a stored row, so HTTP search hydrates its
        hits as it does for ingested documents: a short excerpt of the
        row's topic as content, and an empty vector blob (the rows were
        bulk-loaded into the index; SQL is not read back)."""
        c, db = self.corpus, self.rt.db
        from memex_tpu_torch.db.connection import utcnow

        now = utcnow()
        t = time.perf_counter()
        excerpt = [c.text_of(w[:12]) for w in c.topic_words]
        with db.transaction() as conn:
            for b in range(c.n_blocks):
                _, topic = c.block(b)
                lo = b * c.BLOCK
                topic = topic.cpu().numpy()
                conn.executemany(
                    "INSERT INTO embeddings (document_id, uuid, segment, content, vector, dim,"
                    " collection, created_at, updated_at) VALUES (?, ?, 0, ?, x'', ?, ?, ?, ?)",
                    [(f"d{lo + i:09d}", sid, excerpt[topic[i]], c.dim, COLLECTION, now, now)
                     for i, sid in enumerate(c.row_ids(lo, lo + len(topic)))])
        log(f"sql: {c.n_rows} embeddings rows in {time.perf_counter() - t:.2f} s")
