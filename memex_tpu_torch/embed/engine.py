"""EmbeddingEngine: load-once, shape-bucketed sentence encoder.

Port of memex_tpu/embed/engine.py. Documents are cut into overlapping
token windows (256 tokens, 86 shared between neighbours) and encoded in
power-of-two batch buckets capped at `max_batch`; queries use the
smallest sequence bucket that fits. Buckets keep the set of shapes the
encoder sees small (the JAX package compiles one executable per bucket;
here they bound what a later CUDA-graph capture has to cover).

Three encode paths, as in memex_tpu:
  - chunked (`_encode_padded`): every bucketed chunk is launched before
    any result is copied back, and the copies come back through one
    `ops.host.fetch`;
  - data-parallel (`devices=[...]`, memex_tpu's `mesh=`): one replica of
    the encoder a device, the bucket rounded up to a multiple of the
    entries and cut into equal contiguous row blocks, one a replica;
  - bulk (`_encode_bulk`), taken on one device from 8 x max_batch
    windows: fixed [8 * max_batch, L] super-chunks uploaded from pinned
    buffers, each batch a [max_batch, L] view of one.
The pooled vectors are cast on the device to `fetch_dtype` (argument, or
MEMEX_ENCODE_FETCH_DTYPE; float32 by default) before the host copy, and
widened to float32 on the host.
"""

from __future__ import annotations

import copy
import os
import threading
import time

import numpy as np
import torch

from ..log import get_logger
from ..metrics import METRICS
from ..ops.host import fetch
from ..parallel.mesh import row_blocks
from ..text import WordPieceTokenizer, encode_windows
from ..text.segment import window_token_ids

from ..models.minilm import MiniLM, MiniLMConfig, load_params

logger = get_logger(__name__)

_SEQ_BUCKETS = (32, 64, 128, 256, 512)
_FETCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


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


def pad_rows(rows: list[list[int]], length: int, pad_id: int,
             batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Rows of token ids -> (ids, mask) [batch, length] int32 arrays, ids
    padded with pad_id. Rows past len(rows) are padding, with mask[:, 0] = 1
    so the mean pooling never divides 0 by 0. batch defaults to len(rows)."""
    batch = len(rows) if batch is None else batch
    ids = np.full((batch, length), pad_id, dtype=np.int32)
    mask = np.zeros((batch, length), dtype=np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    mask[len(rows):, 0] = 1
    return ids, mask


def _batch_bucket(n: int, max_batch: int) -> int:
    b = 8
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def _canonical(device: torch.device | str) -> torch.device:
    """`cuda` names the current card: give it its index, so that entries
    naming one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class EmbeddingEngine:
    """Thread-safe sentence-embedding front end on `device`.

      encode(text)        -> (segments, [S, D] vectors)
      encode_many(texts)  -> encode() for several documents in one stream
      encode_single(text) -> [D] vector
      encode_batch(texts) -> [N, D], one vector per pre-chunked text

    `devices` (default `[device]`) spreads each batch over one replica of
    the encoder a device; entries that repeat a device share one replica.
    `fetch_dtype` (float32, float16 or bfloat16; None reads
    MEMEX_ENCODE_FETCH_DTYPE) is the dtype the vectors cross to the host
    in.
    """

    def __init__(self, model_dir: str | None = None, max_seq_length: int = 256,
                 window_stride: int = 86, max_batch: int = 512, seed: int = 0,
                 *, device: torch.device | str, devices: list | None = None,
                 fetch_dtype: str | None = None):
        self.device = torch.device(device)
        self.max_seq_length = max_seq_length
        self.window_stride = window_stride
        self.max_batch = max_batch
        if fetch_dtype is None:
            fetch_dtype = os.environ.get("MEMEX_ENCODE_FETCH_DTYPE", "float32")
        if fetch_dtype not in _FETCH_DTYPES:
            raise ValueError(f"fetch_dtype must be one of {sorted(_FETCH_DTYPES)}, "
                             f"got {fetch_dtype!r}")
        self.fetch_dtype = fetch_dtype
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
        self._set_devices([self.device] if devices is None else devices)

    def _set_devices(self, devices: list) -> None:
        """One replica of `self.model` for each entry of `devices`; entries
        that repeat a device share one, and the model's own device uses
        the model itself."""
        if not devices:
            raise ValueError("devices must name at least one device")
        self.devices = [_canonical(d) for d in devices]
        replicas = {_canonical(self.device): self.model}
        self._replicas = [replicas.setdefault(d, copy.deepcopy(self.model).to(d))
                          for d in self.devices]

    def encode_ids(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """[B, L] int ids/mask (host) -> [B, D] unit vectors on the device."""
        with torch.inference_mode():
            return self.model(torch.from_numpy(ids).to(self.device),
                              torch.from_numpy(mask).to(self.device))

    def _forward(self, replica: MiniLM, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, D] vectors on the replica's device, cast there to fetch_dtype."""
        return replica(ids, mask).to(_FETCH_DTYPES[self.fetch_dtype])

    def _encode_padded(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Encode [N, L] in bucketed chunks of at most max_batch rows, or
        through `_encode_bulk` from 8 x max_batch rows on one device. Every
        chunk (every row block, over several devices) is launched before
        any result is copied back, so the copies queue behind the remaining
        forwards instead of stalling them."""
        N, L = ids.shape
        out = np.empty((N, self.dim), dtype=np.float32)
        n_dev = len(self.devices)
        if n_dev == 1 and N >= 8 * self.max_batch:
            return self._encode_bulk(ids, mask, out)
        spans, vecs = [], []
        with torch.inference_mode():
            for start in range(0, N, self.max_batch):
                take = min(self.max_batch, N - start)
                B = _batch_bucket(take, self.max_batch)
                # Equal row blocks, one a device entry (memex_tpu: B a
                # multiple of the mesh size).
                B = -(-B // n_dev) * n_dev
                chunk_ids = torch.zeros((B, L), dtype=torch.int32)
                chunk_mask = torch.zeros((B, L), dtype=torch.int32)
                chunk_ids[:take] = torch.from_numpy(ids[start : start + take])
                chunk_mask[:take] = torch.from_numpy(mask[start : start + take])
                # Pad rows keep one unmasked token: no 0/0 in the pooling.
                chunk_mask[take:, 0] = 1
                for replica, blk_ids, blk_mask in zip(
                        self._replicas, row_blocks(chunk_ids, self.devices),
                        row_blocks(chunk_mask, self.devices)):
                    vecs.append(self._forward(replica, blk_ids, blk_mask))
                spans.append((start, take))
        host = fetch(*vecs)
        for i, (start, take) in enumerate(spans):
            rows = np.concatenate(host[i * n_dev : (i + 1) * n_dev])
            out[start : start + take] = rows[:take]
        return out

    def _encode_bulk(self, ids: np.ndarray, mask: np.ndarray, out: np.ndarray,
                     phases: dict | None = None) -> np.ndarray:
        """Large-ingest path on the first device entry: ids and mask go up
        in fixed [8 * max_batch, L] super-chunks, each from one of two
        pinned staging buffers, and every batch is a [max_batch, L] view of
        a super-chunk on the device, so the encoder sees one shape. On a
        card the uploads run on a copy stream the forwards wait on, so
        upload i+1 overlaps forward i; before the host refills a staging
        buffer it waits on the event recorded after that buffer's last
        upload. The padded tail keeps mask[:, 0] = 1. `phases` (benchmark
        telemetry) gets dispatch_s, device_sync_s and fetch_s."""
        N, L = ids.shape
        B = self.max_batch
        SC = 8 * B
        dev, replica = self.devices[0], self._replicas[0]
        cuda = dev.type == "cuda"
        staging = [torch.empty((2, SC, L), dtype=torch.int32, pin_memory=cuda)
                   for _ in range(2)]
        uploaded: list[torch.cuda.Event | None] = [None, None]
        copy_stream = torch.cuda.Stream(dev) if cuda else None
        compute = torch.cuda.current_stream(dev) if cuda else None
        t0 = time.perf_counter()
        spans, vecs = [], []
        with torch.inference_mode():
            for j, sc in enumerate(range(0, N, SC)):
                n_here = min(SC, N - sc)
                host = staging[j % 2]
                if uploaded[j % 2] is not None:
                    uploaded[j % 2].synchronize()  # its last upload has left it
                host[0, :n_here] = torch.from_numpy(ids[sc : sc + n_here])
                host[1, :n_here] = torch.from_numpy(mask[sc : sc + n_here])
                host[:, n_here:] = 0
                host[1, n_here:, 0] = 1  # pad rows: no 0/0 in the pooling
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        chunk = host.to(dev, non_blocking=True)
                    uploaded[j % 2] = torch.cuda.Event()
                    uploaded[j % 2].record(copy_stream)
                    compute.wait_event(uploaded[j % 2])
                    chunk.record_stream(compute)
                else:
                    chunk = host  # the CPU forwards below finish before the refill
                for base in range(0, n_here, B):
                    vecs.append(self._forward(replica, chunk[0, base : base + B],
                                              chunk[1, base : base + B]))
                    spans.append((sc + base, min(B, n_here - base)))
        if phases is not None:
            phases["dispatch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if cuda:  # the last batch's output, as memex_tpu waits on
                last = torch.cuda.Event()
                last.record(compute)
                last.synchronize()
            phases["device_sync_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        for (lo, take), rows in zip(spans, fetch(*vecs)):
            out[lo : lo + take] = rows[:take]
        if phases is not None:
            phases["fetch_s"] = time.perf_counter() - t0
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
        with METRICS.span("embed.tokenize"):
            segmented = [self._window_doc(t) for t in texts]
            ids, mask = pad_rows([w for _, ws in segmented for w in ws], self.max_seq_length,
                                 self.tokenizer.pad_id)
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
        ids, mask = pad_rows([ids_list], seq_bucket(len(ids_list), self.max_seq_length),
                             self.tokenizer.pad_id)
        with self._lock:
            return self._encode_padded(ids, mask)[0]

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        """Embed pre-chunked texts, one vector each ([N, D])."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        ids, mask = encode_windows(texts, self.tokenizer, self.max_seq_length)
        with self._lock:
            return self._encode_padded(ids, mask)
