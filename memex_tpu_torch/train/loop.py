"""Encoder fine-tuning loop (port of memex_tpu/train/loop.py): SQL corpus
-> contrastive pairs -> data-parallel train loop -> HF-format export
servable via EMBEDDING_MODEL.

Pairing is self-supervised from the ingest layout: overlapping windows of
the same document (stride 86 of 256 tokens) are positives; everything else
in the batch is a negative.

Checkpointing: the full train state round-trips through one .npz in
memex_tpu's layout (arr_0 .. arr_N in `jax.tree.leaves` order of
{"opt", "params", "step"}: Adam's count, then mu, nu and the params as
memex_tpu pytrees with dense weights [in, out], then the step), so a run
resumes across the two packages in either direction. The final encoder
exports to HF format (models/minilm.save_params).
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from ..log import get_logger
from ..models.minilm import MiniLM, params_from_numpy, params_to_numpy, save_params
from ..parallel.mesh import local_mesh
from .contrastive import TrainConfig, init_train_state, make_train_step

logger = get_logger(__name__)


def _leaves(tree) -> list:
    """jax.tree.leaves of a tree of dicts and lists: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _unflatten(template, leaves: list):
    """Inverse of _leaves: `leaves` in template's order -> the same tree."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    return build(template)


def _named(state, key: str) -> dict[str, torch.Tensor]:
    names = [n for n, _ in state["params"].named_parameters()]
    return dict(zip(names, state["opt"].moments(key)))


def save_train_state(state, path: str) -> None:
    opt = state["opt"]
    leaves = ([np.int32(opt.count)]
              + _leaves(params_to_numpy(_named(state, "mu")))
              + _leaves(params_to_numpy(_named(state, "nu")))
              + _leaves(params_to_numpy(state["params"]))
              + [np.int32(state["step"])])
    np.savez(path, *[np.asarray(leaf) for leaf in leaves])


def load_train_state(template, path: str):
    """Restore into `template` (a fresh init_train_state), in place."""
    arrs = np.load(path)
    leaves = [arrs[f"arr_{i}"] for i in range(len(arrs.files))]
    model, opt = template["params"], template["opt"]
    tree = params_to_numpy(model)
    n = len(_leaves(tree))
    assert len(leaves) == 3 * n + 2, "checkpoint/config mismatch"

    def state_dict(chunk):
        return params_from_numpy(_unflatten(tree, chunk))

    model.load_state_dict(state_dict(leaves[1 + 2 * n: 1 + 3 * n]))
    for key, chunk in (("mu", leaves[1: 1 + n]), ("nu", leaves[1 + n: 1 + 2 * n])):
        sd = state_dict(chunk)
        for name, m in _named(template, key).items():
            m.copy_(sd[name])
    opt.count = int(leaves[0])
    template["step"] = int(leaves[-1])
    return template


def pairs_from_sql(rt, collection: str) -> list[tuple[str, str]]:
    """Adjacent overlapping windows of each document form positive pairs."""
    rows = rt.db.query(
        "SELECT document_id, segment, content FROM embeddings "
        "WHERE collection = ? ORDER BY document_id, segment",
        (collection,),
    )
    pairs: list[tuple[str, str]] = []
    prev = None
    for row in rows:
        cur = (row["document_id"], row["segment"], row["content"])
        if prev is not None and prev[0] == cur[0] and cur[1] == prev[1] + 1:
            pairs.append((prev[2], cur[2]))
        prev = cur
    if not pairs:  # single-window docs: pair each segment with itself
        pairs = [(r["content"], r["content"]) for r in rows]
    return pairs


def _tokenize_pairs(engine, pairs, max_len: int):
    tok = engine.tokenizer
    n = len(pairs)
    q_ids = np.full((n, max_len), tok.pad_id, np.int32)
    q_mask = np.zeros((n, max_len), np.int32)
    d_ids = np.full((n, max_len), tok.pad_id, np.int32)
    d_mask = np.zeros((n, max_len), np.int32)
    for i, (q, d) in enumerate(pairs):
        for ids_arr, mask_arr, text in ((q_ids, q_mask, q), (d_ids, d_mask, d)):
            e = tok.encode(text, add_special_tokens=True)[:max_len]
            ids_arr[i, : len(e)] = e
            mask_arr[i, : len(e)] = 1
    return q_ids, q_mask, d_ids, d_mask


def train_encoder(
    rt,
    collection: str,
    epochs: int = 1,
    batch_size: int = 32,
    max_len: int = 64,
    tc: TrainConfig | None = None,
    out_dir: str | None = None,
    resume: str | None = None,
    checkpoint_path: str | None = None,
    seed: int = 0,
    *,
    devices: list[torch.device | str] | None = None,
) -> dict:
    """Fine-tune the runtime's encoder on `collection`; returns metrics.
    `devices` (default: every card of the runtime's device type, as
    memex_tpu spans jax.devices()) takes one row block of each batch."""
    tc = tc or TrainConfig()
    engine = rt.engine
    cfg = replace(engine.cfg, compute_dtype="float32")
    pairs = pairs_from_sql(rt, collection)
    if not pairs:
        raise ValueError(f"collection {collection!r} has no segments to train on")
    logger.info("training on %d pairs from %r", len(pairs), collection)
    q_ids, q_mask, d_ids, d_mask = _tokenize_pairs(engine, pairs, max_len)

    devices = [torch.device(d) for d in (devices or local_mesh(rt.device))]
    n_dev = len(devices)
    batch_size = max(n_dev, (batch_size // n_dev) * n_dev)
    # Small collections: shrink the batch to the largest device multiple
    # that fits -- otherwise the epoch loop runs ZERO steps and the
    # unmodified encoder would be exported as if fine-tuned.
    if len(pairs) < batch_size:
        batch_size = max(n_dev, (len(pairs) // n_dev) * n_dev)
        if len(pairs) < batch_size:
            raise ValueError(
                f"collection {collection!r} has only {len(pairs)} pairs — "
                f"fewer than the {n_dev}-device minimum batch")
        logger.info("batch_size reduced to %d (%d pairs)", batch_size, len(pairs))

    # float32 master params, a new module: the engine's own (its dense
    # weights cast to the compute dtype) keeps serving unchanged.
    with torch.device(devices[0]):
        model = MiniLM(cfg)
    model.load_state_dict({k: v.float() for k, v in engine.model.state_dict().items()})
    state = init_train_state(cfg, model, tc)
    if resume:
        state = load_train_state(state, resume)
        logger.info("resumed from %s at step %d", resume, state["step"])
    step_fn = make_train_step(cfg, tc, devices)

    rng = np.random.default_rng(seed)
    n = len(pairs)
    metrics = {}
    for epoch in range(epochs):
        order = rng.permutation(n)
        t0 = time.perf_counter()
        for s in range(0, n - batch_size + 1, batch_size):
            sel = order[s : s + batch_size]
            batch = {"q_ids": q_ids[sel], "q_mask": q_mask[sel],
                     "d_ids": d_ids[sel], "d_mask": d_mask[sel]}
            state, metrics = step_fn(state, batch)
        logger.info(
            "epoch %d: loss %.4f acc %.3f (%.3fs)", epoch,
            float(metrics.get("loss", np.nan)), float(metrics.get("accuracy", np.nan)),
            time.perf_counter() - t0,
        )
        if checkpoint_path:
            save_train_state(state, checkpoint_path)
    if out_dir:
        save_params(out_dir, cfg, state["params"], vocab=engine.tokenizer.vocab)
        logger.info("exported fine-tuned encoder to %s (HF format)", out_dir)
    return {k: float(v) for k, v in metrics.items()} | {"pairs": n, "step": state["step"]}
