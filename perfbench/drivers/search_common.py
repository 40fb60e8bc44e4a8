"""What the search drivers share: warming the shapes the traffic uses,
the probed union of IVF batches, and the reference check."""

from __future__ import annotations

import numpy as np

from ..check import sample_of, search_readings
from ..common import Ctx, free_runtime, log, rng, sync
from ..stores import COLLECTION, Prepared


def warm(prep: Prepared, k: int, max_tokens: int) -> int:
    """Every Q bucket at each sequence bucket the queries can reach (the
    fused path), or every Q bucket of search_batch and every batch bucket
    of encode_batch (the IVF path, whose queries encode at L = 256)."""
    from memex_tpu_torch.embed.engine import seq_bucket

    rt = prep.rt
    seq = sorted({seq_bucket(n, rt.settings.max_seq_length) for n in (1, max_tokens)})
    n = rt.search_batcher.warmup(COLLECTION, k, seq_lens=tuple(seq))
    if not hasattr(prep.store.index, "buf"):  # IVF: its encoder batches too
        for b in (1, 8, 16, 32, 64, 128):
            rt.engine.encode_batch(["warm"] * b)
            n += 1
    sync(prep.ctx.device)
    return n


class ProbedRows:
    """Live rows in the union of clusters each IVF search batch probes, as
    the window's own batches are routed: wraps the program's `route_union`
    (which `ivf_batch_search` calls) and, while `on`, adds the union's row
    count to a list on the device, read only after the window. A flat
    store leaves the list empty."""

    def __init__(self, prep: Prepared):
        import torch
        import memex_tpu_torch.ops.ivf_batch as ivf

        self.on = False
        self._got: list = []
        self._mod, self._orig = ivf, ivf.route_union
        index = prep.store.index
        if getattr(index, "centroids", None) is None:
            return
        sizes = index.sizes

        def route_union(centroids, queries, nprobe, *args, **kw):
            clist, n_act = self._orig(centroids, queries, nprobe, *args, **kw)
            if self.on:
                live = torch.arange(clist.shape[0], device=clist.device) < n_act
                self._got.append((sizes[clist.long()] * live).sum())
            return clist, n_act

        ivf.route_union = route_union

    def close(self) -> list[int]:
        self._mod.route_union = self._orig
        self.on = False
        return [int(x) for x in self._got]


def ivf_union(prep: Prepared, queries: list[str], sizes=(32, 128)) -> dict:
    """Mean live rows and chunks of the probed union of batches of the
    traffic's queries, routed as the program routes them (its centroids,
    its query vectors): the bytes K5 must read a batch."""
    import torch
    from memex_tpu_torch.ops.ivf_batch import route_union

    index = prep.store.index
    if not hasattr(index, "centroids") or index.centroids is None:
        return {}
    sizes_h = index.sizes.cpu().numpy()
    S = 1024 if index.data.shape[1] % 1024 == 0 else 512
    out = {}
    for q_n in sizes:
        lives, chunks, clusters = [], [], []
        for s in range(0, min(len(queries), 8 * q_n), q_n):
            vecs = prep.rt.engine.encode_batch(queries[s : s + q_n])
            lst, n_act = route_union(index.centroids,
                                     torch.from_numpy(vecs).to(index.centroids.device),
                                     index.nprobe)
            act = lst[: int(n_act.item())].cpu().numpy()
            lives.append(int(sizes_h[act].sum()))
            chunks.append(int(np.maximum(1, -(-sizes_h[act] // S)).sum()))
            clusters.append(len(act))
        out[q_n] = {"live": float(np.mean(lives)), "chunks": float(np.mean(chunks)),
                    "clusters": float(np.mean(clusters))}
    return out


def own_topic_share(prep: Prepared, pool: list[tuple[int, str]], n: int = 1024) -> float:
    """Share of queries whose nearest centre (reference embeddings) is
    their own topic."""
    from ..reference import minilm as ref_minilm

    c = prep.corpus
    sub = pool[:n]
    q = ref_minilm.encode_ids(prep.weights, prep.model_cfg,
                              [c.tok.encode(t) for _, t in sub], c.tok.pad)
    best = (q @ c.centres.T).argmax(dim=1).cpu().numpy()
    return float(np.mean(best == np.array([t for t, _ in sub])))


def check(ctx: Ctx, prep: Prepared, completed: list[tuple[str, list]], k: int) -> dict:
    """Free the program's state, then judge a seeded sample of the
    window's answers against the reference."""
    free_runtime(prep.rt, COLLECTION)
    prep.store = None
    sample = sample_of(completed, int(ctx.traffic["check_sample"]),
                       rng(ctx.seed, "check"))
    if not sample:
        return {"worst_gap": float("inf"), "recall_at_10": 0.0, "n": 0, "bad": 0}
    r = search_readings(prep.corpus, prep.weights, prep.model_cfg, sample, k)
    log(f"check: {r}")
    return r
