"""The benchmark's inputs, all made from the run's seed: the vocabulary,
the encoder's weights and their HF-format checkpoint, the topics and
their centres, the stored rows, the queries and the documents.

Sizes and arrival gaps are drawn once from a fixed seed and only put in
another order by the run's seed, so every seed does the same amount of
work; which words, topics and rows is the run seed's choice.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .common import derive, rng
from .reference import minilm as ref_minilm
from .reference.wordpiece import SPECIALS, WordPiece

VOCAB_SIZE = 30522
SHAPE_SEED = 0  # the seed of sizes and arrivals, the same in every run


def make_vocab(size: int = VOCAB_SIZE) -> list[str]:
    """A WordPiece vocabulary of exactly `size` entries: the specials,
    printable ASCII as word-initial and "##" pieces, then lowercase whole
    words of 3-9 letters drawn from a fixed seed. The traffic's words are
    the whole words, one token each."""
    chars = [chr(c) for c in range(0x21, 0x7F)]
    vocab = list(SPECIALS) + chars + ["##" + c for c in chars]
    seen = set(vocab)
    g = np.random.default_rng(12345)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < size:
        n = int(g.integers(3, 10))
        w = "".join(g.choice(letters, n))
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab


def content_seed(store: dict, seed: int) -> int:
    """The seed of the stored data and of the model's weights: the run's,
    unless the configuration fixes its deployment's data (`content_seed`);
    the run's seed then draws only the traffic."""
    return int(store.get("content_seed", seed))


def first_word_id(vocab: list[str]) -> int:
    return len(SPECIALS) + 2 * 94


# -- weights ---------------------------------------------------------------


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (cfg["vocab_size"], H)),
           ("embeddings.position_embeddings.weight", (cfg["max_position_embeddings"], H)),
           ("embeddings.token_type_embeddings.weight", (cfg["type_vocab_size"], H)),
           ("embeddings.LayerNorm.weight", (H,)), ("embeddings.LayerNorm.bias", (H,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)),
                            ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (I, H)), ("output.dense", (H, I))):
            out += [(p + name + ".weight", shape), (p + name + ".bias", (shape[0],))]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(p + ln + ".weight", (H,)), (p + ln + ".bias", (H,))]
    return out


def make_weights(cfg: dict, seed: int, device: str) -> dict[str, torch.Tensor]:
    """Every tensor from one normal draw on the device: N(0, 0.02^2), and
    LayerNorm scales 1 + N(0, 0.02^2), as a trained BERT's are near."""
    shapes = param_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = 0.02 * torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        t = flat[at : at + n].view(shape)
        if "LayerNorm.weight" in name:
            t = t + 1.0
        out[name] = t
        at += n
    return out


def write_checkpoint(path: str, cfg: dict, weights: dict, vocab: list[str]) -> None:
    """model.safetensors (float32, HF BERT names), config.json, vocab.txt."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: v.detach().float().cpu().contiguous() for k, v in weights.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")


# -- texts -----------------------------------------------------------------


def lognormal_ints(g: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """n draws of a log-normal with median spec["median"] and shape
    spec["sigma"], rounded and clipped to [min, max]."""
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * g.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


class Corpus:
    """Topics, centres, rows and queries of one run.

    Topic t is a text of 32-128 whole words; its centre is the reference
    encoder's float32 embedding of that text (topics and rows from the
    data seed, queries from the run's seed). Row i belongs to a uniform
    topic and is unit(centre + noise) with cos ~ `cos_to_centre`; rows are
    drawn on the device in blocks, block b from its own generator, so any
    block is made again bit for bit when the reference needs it."""

    BLOCK = 1 << 18

    def __init__(self, seed: int, model_cfg: dict, store: dict, device: str,
                 vocab: list[str]):
        self.seed = seed
        self.data_seed = content_seed(store, seed)
        self.device = device
        self.vocab = vocab
        self.tok = WordPiece(vocab)
        self.words = np.array(vocab[first_word_id(vocab):], dtype=object)
        self.n_rows = int(store["rows"])
        self.n_topics = int(store["topics"])
        self.dim = model_cfg["hidden_size"]
        cos = float(store["cos_to_centre"])
        # |noise| = sigma * sqrt(D) = tan(arccos(cos)) gives that cosine.
        self.sigma = float(np.tan(np.arccos(cos)) / np.sqrt(self.dim))
        lens = lognormal_ints(np.random.default_rng(SHAPE_SEED), self.n_topics,
                              {"median": 64, "sigma": 0.35, "min": 32, "max": 128})
        g = rng(self.data_seed, "topics")
        lens = g.permutation(lens)
        self.topic_words = [g.choice(len(self.words), int(n), replace=False) for n in lens]
        self.model_cfg = model_cfg
        self.centres = None

    def embed_centres(self, weights: dict) -> None:
        """The topics' centres: the reference encoder's float32 embeddings."""
        texts = [self.text_of(w) for w in self.topic_words]
        self.centres = ref_minilm.encode_ids(weights, self.model_cfg,
                                             [self.tok.encode(t) for t in texts],
                                             self.tok.pad)

    def text_of(self, word_ids) -> str:
        return " ".join(self.words[np.asarray(word_ids)])

    def block(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rows of block b ([m, D] float32 unit, on the device) and their topics."""
        lo = b * self.BLOCK
        m = min(self.BLOCK, self.n_rows - lo)
        g = torch.Generator(device=self.device).manual_seed(derive(self.data_seed, "rows", b))
        topic = torch.randint(0, self.n_topics, (m,), generator=g, device=self.device)
        v = self.centres[topic] + self.sigma * torch.randn(
            (m, self.dim), generator=g, device=self.device)
        return v / v.norm(dim=1, keepdim=True), topic

    @property
    def n_blocks(self) -> int:
        return -(-self.n_rows // self.BLOCK)

    def row_ids(self, lo: int, hi: int) -> list[str]:
        return [f"r{i:09d}" for i in range(lo, hi)]

    def queries(self, n: int, spec: dict) -> list[tuple[int, str]]:
        """n (topic, text) queries: a uniform topic, then a log-normal
        number of that topic's words, without repeats."""
        lens = lognormal_ints(np.random.default_rng(SHAPE_SEED + 1), n, spec)
        g = rng(self.seed, "queries")
        lens = g.permutation(lens)
        topics = g.integers(0, self.n_topics, n)
        out = []
        for t, k in zip(topics, lens):
            words = self.topic_words[t]
            pick = g.choice(words, min(int(k), len(words)), replace=False)
            out.append((int(t), self.text_of(pick)))
        return out


def row_of(sid) -> int:
    """The row index an id names, or -1 for anything that is not a row id."""
    if isinstance(sid, str) and len(sid) == 10 and sid[0] == "r" and sid[1:].isdigit():
        return int(sid[1:])
    return -1
