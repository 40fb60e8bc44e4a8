"""EmbeddingEngine: load-once, shape-bucketed sentence encoder on one device.

Port of memex_tpu/embed/engine.py. Documents are cut into overlapping
token windows (256 tokens, 86 shared between neighbours) and encoded in
power-of-two batch buckets capped at `max_batch`; queries use the
smallest sequence bucket that fits. Buckets keep the set of shapes the
encoder sees small (the JAX package compiles one executable per bucket;
here they bound what a later CUDA-graph capture has to cover).

The JAX engine's mesh sharding and its bulk transfer path are not ported:
one chunked path gives the same vectors on one card.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from memex_tpu.log import get_logger
from memex_tpu.text import WordPieceTokenizer, encode_windows
from memex_tpu.text.segment import window_token_ids

from ..models.minilm import MiniLM, MiniLMConfig, load_params

logger = get_logger(__name__)

_SEQ_BUCKETS = (32, 64, 128, 256, 512)


def seq_bucket(n: int, max_seq_length: int) -> int:
    """Padded sequence length for n tokens: the smallest _SEQ_BUCKET that
    fits, with max_seq_length always the terminal bucket. Shared by
    encode_single and the fused query path."""
    for b in _SEQ_BUCKETS:
        if b >= max_seq_length:
            break
        if n <= b:
            return b
    return max_seq_length


def _batch_bucket(n: int, max_batch: int) -> int:
    b = 8
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class EmbeddingEngine:
    """Thread-safe sentence-embedding front end on `device`.

      encode(text)        -> (segments, [S, D] vectors)
      encode_many(texts)  -> encode() for several documents in one stream
      encode_single(text) -> [D] vector
      encode_batch(texts) -> [N, D], one vector per pre-chunked text
    """

    def __init__(self, model_dir: str | None = None, max_seq_length: int = 256,
                 window_stride: int = 86, max_batch: int = 512, seed: int = 0,
                 *, device: torch.device | str):
        self.device = torch.device(device)
        self.max_seq_length = max_seq_length
        self.window_stride = window_stride
        self.max_batch = max_batch
        self._lock = threading.Lock()
        if model_dir and model_dir != "random":
            self.cfg, model = load_params(model_dir)
            self.tokenizer = WordPieceTokenizer.from_pretrained_dir(model_dir)
            logger.info("loaded MiniLM checkpoint from %s", model_dir)
        else:
            self.tokenizer = WordPieceTokenizer()
            self.cfg = MiniLMConfig(vocab_size=self.tokenizer.vocab_size)
            model = MiniLM(self.cfg).init_random(seed)
            logger.info("initialized random MiniLM (seed=%d)", seed)
        self.model = model.cast_to_compute().to(self.device).eval()
        self.dim = self.cfg.hidden_size

    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """[B, L] int ids/mask (host) -> [B, D] unit vectors on the device."""
        with torch.inference_mode():
            return self.model(torch.from_numpy(ids).to(self.device),
                              torch.from_numpy(mask).to(self.device))

    def _encode_padded(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Encode [N, L] in bucketed chunks of at most max_batch rows. Every
        chunk is launched before any result is copied back, so the copies
        queue behind the remaining forwards instead of stalling them."""
        N, L = ids.shape
        out = np.empty((N, self.dim), dtype=np.float32)
        pending = []
        for start in range(0, N, self.max_batch):
            take = min(self.max_batch, N - start)
            B = _batch_bucket(take, self.max_batch)
            chunk_ids = np.zeros((B, L), dtype=np.int32)
            chunk_mask = np.zeros((B, L), dtype=np.int32)
            chunk_ids[:take] = ids[start : start + take]
            chunk_mask[:take] = mask[start : start + take]
            # Pad rows keep one unmasked token: no 0/0 in the pooling.
            chunk_mask[take:, 0] = 1
            pending.append((start, take, self.encode_ids(chunk_ids, chunk_mask)))
        for start, take, vecs in pending:
            out[start : start + take] = vecs[:take].cpu().numpy()
        return out

    def _window_doc(self, text: str) -> tuple[list[str], list[list[int]]]:
        raw = self.tokenizer.encode(text, add_special_tokens=False)
        if not raw:
            raw = [self.tokenizer.unk_id]
        windows = window_token_ids(raw, self.tokenizer, self.max_seq_length,
                                   self.window_stride)
        return [self.tokenizer.decode(w) for w in windows], windows

    def encode(self, text: str) -> tuple[list[str], np.ndarray]:
        """Segment a document into overlapping token windows and embed
        every window: (decoded segments, [S, D] unit vectors)."""
        return self.encode_many([text])[0]

    def encode_many(self, texts: list[str]) -> list[tuple[list[str], np.ndarray]]:
        """encode() over several documents, all their windows in one stream."""
        segmented = [self._window_doc(t) for t in texts]
        all_windows = [w for _, ws in segmented for w in ws]
        L = self.max_seq_length
        ids = np.full((len(all_windows), L), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((len(all_windows), L), dtype=np.int32)
        for i, w in enumerate(all_windows):
            ids[i, : len(w)] = w
            mask[i, : len(w)] = 1
        with self._lock:
            vecs = self._encode_padded(ids, mask)
        out = []
        start = 0
        for segments, ws in segmented:
            out.append((segments, vecs[start : start + len(ws)]))
            start += len(ws)
        return out

    def encode_single(self, text: str) -> np.ndarray:
        """Truncate-and-embed one query, at the smallest seq bucket that fits."""
        ids_list = self.tokenizer.encode(text, add_special_tokens=True)[: self.max_seq_length]
        L = seq_bucket(len(ids_list), self.max_seq_length)
        ids = np.full((1, L), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((1, L), dtype=np.int32)
        ids[0, : len(ids_list)] = ids_list
        mask[0, : len(ids_list)] = 1
        with self._lock:
            return self._encode_padded(ids, mask)[0]

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """Embed pre-chunked texts, one vector each ([N, D])."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        ids, mask = encode_windows(texts, self.tokenizer, self.max_seq_length)
        with self._lock:
            return self._encode_padded(ids, mask)
