"""FlatIndex: exact brute-force vector index resident on one device.

Port of memex_tpu/index/flat.py: the float32, bfloat16, int8 (with or
without query quantization) and int4 tiers, each optionally with a rerank
and, for the quantized tiers, a residual-refinement store. The rows live
in power-of-two-capacity buffers on the device; `count` and the tombstone
mask `alive` select the live prefix, so ingest and search never reshape
anything until a capacity doubling. Search runs the fused score+top-k
scans (ops/fused_topk.py: CUDA kernels for buffers on the card) or, where
the fused path does not apply, the plain two-stage scan.

Storage by tier:
  float32/bfloat16  buf [cap, D] rows;
  int8              buf [cap, D] int8 codes, scales [cap];
  int4              buf [cap, D/2] packed int4 rows (row-major, where
                    memex_tpu keeps them transposed for its TPU tiles),
                    buf8 [cap, D] int8 rerank copy, scales [cap] (the int8
                    scales; the int4 ones are those times 127/7);
  refine            rbuf [cap, D] int8 codes of the quantization residual,
                    rbuf_scales [cap].

Stores centre their rows: the mean of the first ingest is pinned and the
buffers hold `v - mean`; search ranks by the residual score and adds the
query-constant `q . mean` back after the top-k. Rows are quantized on the
host (memex_tpu.native_lib, as memex_tpu does, so both packages store the
same codes), and a host shadow mirrors every stored row (int8 codes for
the quantized tiers), so save() and compact() read no device bytes, except
after add_quantized(), whose rows exist only on the device. The
checkpoint format (v2, incremental segments) is memex_tpu's, byte for
byte, so either package loads the other's checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..log import get_logger

from ..ops.fused_topk import (
    fused_score_topk,
    fused_score_topk_int4_rerank,
    fused_score_topk_int8,
    fused_score_topk_int8q,
    np_quantize_rows_int4,
    pack_int4_from_int8,
    scores_f32,
)
from ..ops.topk import blockwise_topk, exact_topk

logger = get_logger(__name__)

MIN_CAPACITY = 2048
_ADD_BUCKETS = (8, 64, 256, 1024)
# Bulk-add streaming chunk (rows).
_ADD_CHUNK = 1 << 17
_QUANTIZED = ("int8", "int4")


def _bucket_rows(m: int) -> int:
    for b in _ADD_BUCKETS:
        if m <= b:
            return b
    return -(-m // _ADD_BUCKETS[-1]) * _ADD_BUCKETS[-1]


def _int4_rerank_depth(k: int) -> int:
    """Candidates the int4 scan hands its int8 rerank (memex_tpu's rule)."""
    return min(max(64, 2 * k), 1024)


def _int4_deferred(q_n: int) -> bool:
    """int4 unpack by batch size, memex_tpu's rule (measured on its TPU):
    deferred up to 64 queries, shift above. On the H100 shift is faster
    from 32 queries up and level with deferred below (PERF.md, section 7),
    but the rule is kept for parity."""
    return q_n <= 64


def _put(dst: torch.Tensor, lo: int, rows) -> None:
    """Write host (numpy) or device rows into dst[lo:lo + len(rows)], in
    place: memex_tpu donates the buffer to an XLA update-slice. A search
    launched earlier on the same stream has already read the old rows in
    stream order."""
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    dst[lo : lo + rows.shape[0]] = rows.to(dst.device, dst.dtype)


def _search_masked_fused(buf, alive, count: int, queries, k: int, kk: int = 128,
                         exact: bool = False, keep2: bool = False):
    """Fused scan into a kk-wide candidate list, then its top-k. `alive`
    (None when the index has no deletes) masks tombstones inside the
    scan, so dead rows never claim candidate slots. keep2 removes mod-S
    slot-collision losses; exact mode sets it so an exact scan is exact
    end to end."""
    vals, idx = fused_score_topk(buf, queries, kk, count=count, alive=alive,
                                 exact=exact, keep2=keep2)
    svals, order = exact_topk(vals, k)
    return svals, torch.gather(idx, 1, order.long())


def _search_masked_fused_int8(buf, scales, alive, count: int, queries, k: int,
                              kk: int = 128, block_n: int = 1024, qquant: bool = True,
                              keep2: bool = False):
    """int8 fused path, tombstones masked in the scan. qquant quantizes the
    queries too (K2, s8 x s8); otherwise bf16 queries (K3, no keep2). The
    bank widths are memex_tpu's: 4 x 128 slots for K2, up to 8 x 128 (from
    block_n) for K3."""
    if qquant:
        vals, idx = fused_score_topk_int8q(buf, scales, queries, kk, count=count, alive=alive,
                                           banks=max(1, min(4, block_n // 128)), keep2=keep2)
    else:
        vals, idx = fused_score_topk_int8(buf, scales, queries, kk, count=count, alive=alive,
                                          banks=max(1, min(8, block_n // 128)))
    svals, order = exact_topk(vals, k)
    return svals, torch.gather(idx, 1, order.long())


def _search_masked_fused_int4(buf4, scales, buf8, alive, count: int, queries, k: int,
                              block_n: int = 8192, rerank: int = 64, deferred: bool = False,
                              banks: int = 8, keep2: bool = False):
    """int4 coarse scan (K4) + exact int8 rerank. The bank is capped at
    block_n // 128 banks, as memex_tpu caps it."""
    return fused_score_topk_int4_rerank(
        buf4, scales, buf8, queries, k, count=count, alive=alive, rerank=rerank,
        banks=max(1, min(banks, block_n // 128)), deferred=deferred, keep2=keep2)


def _exact_flat_rerank(buf, scales, queries, vals, idx, keep: int, rbuf=None,
                       rbuf_scales=None):
    """Re-score a coarse search's candidate rows in true float32 and keep
    the top `keep`. Quantized rows are decoded with their scale, and with
    the residual store (rbuf, rbuf_scales) when there is one. Sentinel
    candidates (vals <= -1e29) keep their sentinel. Returns (vals, idx)
    [Q, keep]."""
    sel = idx.long()
    rows = buf[sel].float()  # [Q, kk, D]
    if scales is not None:
        rows = rows * scales[sel][..., None]
    if rbuf is not None:
        rows = rows + rbuf[sel].float() * rbuf_scales[sel][..., None]
    scores = scores_f32(queries[:, None, :], rows.transpose(1, 2), exact=True)[:, 0]
    scores = torch.where(vals > -1e29, scores, vals)
    top_v, top_j = exact_topk(scores, keep)
    return top_v, torch.gather(idx, 1, top_j.long())


def _search_rerank_fused(buf, scales, buf8, rbuf, rscales, alive, count: int, queries,
                         k: int, k_ret: int, kk: int, block_n: int, qquant: bool,
                         deferred: bool, dtype: str, exact: bool, banks4: int = 16,
                         keep2: bool = True):
    """Coarse fused scan for k_ret candidates, then the exact (or refine)
    rerank to k. memex_tpu composes both into one executable; here they
    are consecutive launches on one stream. `dtype` selects the scan."""
    if dtype == "int4":
        vals, idx = _search_masked_fused_int4(
            buf, scales, buf8, alive, count, queries, k_ret, block_n=block_n, rerank=kk,
            deferred=deferred, banks=min(banks4, max(1, block_n // 128)), keep2=keep2)
        src = buf8
    elif dtype == "int8":
        vals, idx = _search_masked_fused_int8(
            buf, scales, alive, count, queries, k_ret, kk=kk, block_n=block_n,
            qquant=qquant, keep2=keep2 and qquant)
        src = buf
    else:
        vals, idx = _search_masked_fused(buf, alive, count, queries, k_ret, kk=kk,
                                         exact=exact, keep2=keep2)
        src = buf
    return _exact_flat_rerank(src, scales, queries, vals, idx, k, rbuf=rbuf,
                              rbuf_scales=rscales)


def _search_plain(buf, scales, alive, count: int, queries, k: int, exact: bool = False):
    """Non-fused scan (memex_tpu's `_search_xla`) for any storage dtype: the
    whole [Q, N] score matrix at the kernels' precision (bf16-rounded
    inputs, or float32 when exact), times the row scales of a quantized
    buffer, tombstones masked before an exact two-stage top-k, so it can
    never fall short of live hits."""
    scores = scores_f32(queries, buf.T, exact=exact)
    if scales is not None:
        scores = scores * scales[None, :]
    scores = torch.where(alive[None, :] > 0, scores, torch.full_like(scores, -1e30))
    return blockwise_topk(scores, k, count=count)


class FlatIndex:
    """Exact cosine/MIPS index over unit vectors, resident on `device`."""

    def __init__(self, dim: int, capacity: int = MIN_CAPACITY,
                 use_fused: bool | None = None, block_n: int = 1024,
                 dtype: str = "float32", query_quantize: bool = True,
                 center: bool | None = None, rerank: int | None = None,
                 scan_precision: str = "default", refine: bool = False, *,
                 device: torch.device | str):
        """dtype: "float32", "bfloat16", "int8" (per-row scales) or "int4"
        (packed int4 scan + int8 rerank copy). query_quantize routes int8
        search through the all-int8 scan (K2) rather than bf16 queries
        (K3). `rerank` re-scores the top-`rerank` scan candidates in true
        float32 (capped at 128, the candidate bank's ceiling). refine
        (quantized tiers) keeps int8 codes of the quantization residual for
        that rerank, and defaults its depth to 128. scan_precision="highest"
        (float32 only) scans in true float32 with the two-per-slot fold.
        block_n sets the int8 bf16-query scan's bank width, as in
        memex_tpu. use_fused defaults to True on a CUDA device."""
        if dtype not in ("float32", "bfloat16", *_QUANTIZED):
            raise ValueError(f"unknown dtype {dtype!r}")
        if dtype == "int4" and dim % 2:
            raise ValueError(f"int4 packing needs an even dim, got {dim}")
        if refine and dtype not in _QUANTIZED:
            raise ValueError("refine stores a residual of the quantization error; "
                             f"{dtype} storage has none")
        if scan_precision not in ("default", "highest"):
            raise ValueError(f"unknown scan_precision {scan_precision!r}")
        if scan_precision == "highest" and dtype != "float32":
            raise ValueError(f"scan_precision='highest' requires float32 storage, got {dtype}")
        self.device = torch.device(device)
        self.dim = dim
        self.dtype = dtype
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None  # None = not pinned yet
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 128
        self.rerank = None if rerank is None else min(int(rerank), 128)
        self.scan_precision = scan_precision
        capacity = max(MIN_CAPACITY, int(capacity))
        self.capacity = 1 << (capacity - 1).bit_length()  # power of two
        self.count = 0
        self.dead = 0
        self.block_n = block_n
        self.query_quantize = query_quantize
        self.use_fused = self.device.type == "cuda" if use_fused is None else use_fused
        self.ids: list[str] = []
        self._id_to_row: dict[str, int] = {}
        self._buf_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                           "int8": torch.int8, "int4": torch.int8}[dtype]
        self._sh_dtype = np.int8 if dtype in _QUANTIZED else np.float32
        self._alloc(self.capacity)
        # Incremental-checkpoint state (see save()). Dead rows are tracked
        # by row index, stable within a generation.
        self.needs_recovery = False  # set by load() when rows were skipped
        self._generation = 0
        self._dead_rows: set[int] = set()
        self._ckpt_path: str | None = None
        self._ckpt_gen = -1
        self._saved_count = 0
        self._segments: list[str] = []

    def _alloc(self, cap: int) -> None:
        """Zeroed device buffers and host shadow for `cap` rows."""
        quant = self.dtype in _QUANTIZED

        def dev(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        width = self.dim // 2 if self.dtype == "int4" else self.dim
        self.buf = dev((cap, width), self._buf_dtype)
        self.buf8 = dev((cap, self.dim), torch.int8) if self.dtype == "int4" else None
        self.scales = dev((cap,), torch.float32) if quant else None
        # Refinement store: rows added without residuals (add_quantized)
        # keep scale 0, so their reconstruction is the coarse code.
        self.rbuf = dev((cap, self.dim), torch.int8) if self.refine else None
        self.rbuf_scales = dev((cap,), torch.float32) if self.refine else None
        self.alive = dev((cap,), torch.float32)
        # Write-through host shadow of the stored (centred) rows: int8
        # codes (int4: the int8 rerank copy; the packed rows are
        # re-derived on load) or float32 rows.
        self._sh_rows = np.zeros((cap, self.dim), self._sh_dtype)
        self._sh_scales = np.zeros((cap,), np.float32) if quant else None
        self._sh_resid = np.zeros((cap, self.dim), np.int8) if self.refine else None
        self._sh_resid_scales = np.zeros((cap,), np.float32) if self.refine else None
        self._sh_valid = True

    # -- mutation -------------------------------------------------------------

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        logger.info("flat index grow %d -> %d", self.capacity, new_cap)
        old = {name: getattr(self, name) for name in (
            "buf", "buf8", "scales", "rbuf", "rbuf_scales", "alive", "_sh_rows",
            "_sh_scales", "_sh_resid", "_sh_resid_scales")}
        sh_valid = self._sh_valid
        self._alloc(new_cap)
        for name, prev in old.items():
            if prev is not None:
                getattr(self, name)[: self.capacity] = prev
        self._sh_valid = sh_valid
        self.capacity = new_cap

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        """Bulk insert of unit-normalized [M, dim] vectors under string ids."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[0] != len(ids) or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors {vectors.shape} do not match {len(ids)} ids x dim {self.dim}")
        if len(set(ids)) < len(ids):
            # Intra-batch duplicates: keep the last occurrence per id (two
            # live rows under one id would leave an undeletable ghost).
            last = {sid: i for i, sid in enumerate(ids)}
            pick = sorted(last.values())
            vectors = vectors[pick]
            ids = [ids[i] for i in pick]
        if any(sid in self._id_to_row for sid in ids):
            # Idempotent re-add: keep existing rows, insert only new ids.
            fresh = [i for i, sid in enumerate(ids) if sid not in self._id_to_row]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        if vectors.shape[0] > _ADD_CHUNK:
            self._grow_to(self.count + vectors.shape[0] + 1)  # once, not per chunk
            for i in range(0, vectors.shape[0], _ADD_CHUNK):
                self._add_screened(vectors[i : i + _ADD_CHUNK], ids[i : i + _ADD_CHUNK])
            return
        self._add_screened(vectors, ids)

    def _add_screened(self, vectors: np.ndarray, ids: list[str],
                      precentered: bool = False) -> None:
        m = vectors.shape[0]
        # Grow by the padded bucket, as memex_tpu does, so both packages
        # reach the same capacities (+1: padded rows never alias live data).
        self._grow_to(self.count + _bucket_rows(m) + 1)
        if self.mean is None:
            self.mean = (vectors.mean(axis=0).astype(np.float32)
                         if self.center and not precentered
                         else np.zeros((self.dim,), np.float32))
        resid = vectors if precentered or not self.mean.any() else vectors - self.mean
        lo = self.count
        if self.dtype in _QUANTIZED:
            resid = np.ascontiguousarray(resid, np.float32)
            if self.refine:
                from ..native_lib import np_quantize_rows_int8_refine

                q, row_scales, rq, rq_scales = np_quantize_rows_int8_refine(resid)
                self._sh_resid[lo : lo + m] = rq
                self._sh_resid_scales[lo : lo + m] = rq_scales
                _put(self.rbuf, lo, rq)
                _put(self.rbuf_scales, lo, rq_scales)
            else:
                from ..native_lib import np_quantize_rows_int8

                q, row_scales = np_quantize_rows_int8(resid)
            self._sh_rows[lo : lo + m] = q
            self._sh_scales[lo : lo + m] = row_scales
            if self.dtype == "int4":
                _put(self.buf, lo, np_quantize_rows_int4(resid)[0])  # scales = s8 * 127/7
                _put(self.buf8, lo, q)
            else:
                _put(self.buf, lo, q)
            _put(self.scales, lo, row_scales)
        else:
            # Float tiers store the residual too (the shadow mirrors
            # storage space exactly, like int8 codes).
            self._sh_rows[lo : lo + m] = resid
            _put(self.buf, lo, np.asarray(resid, np.float32))
        self.alive[lo : lo + m] = 1.0
        for i, sid in enumerate(ids):
            self._id_to_row[sid] = lo + i
        self.ids.extend(ids)
        self.count = lo + m

    def add_quantized(self, codes_dev, scales_dev, ids: list[str],
                      n_valid: int | None = None,
                      host_codes: np.ndarray | None = None,
                      host_scales: np.ndarray | None = None,
                      resid_dev=None, resid_scales_dev=None,
                      host_resid: np.ndarray | None = None,
                      host_resid_scales: np.ndarray | None = None) -> None:
        """Device-to-device bulk insert of already-quantized int8 rows
        (int8 tier only; fresh ids, no duplicate screening). Rows at index
        >= n_valid are padding from shape-bucketed callers and never land.
        Without host_codes/host_scales the host shadow is invalidated, and
        later checkpoints record `rows_skipped` for recovery from SQL.
        resid_dev/resid_scales_dev (and host_resid/host_resid_scales) carry
        the residual store of a refine index; rows without them keep
        residual scale 0."""
        if self.dtype != "int8":
            raise ValueError("device insert is int8-only")
        if self.mean is None:
            # Caller-quantized rows are raw-space codes: pin a zero mean so
            # later host adds stay in the same code space.
            self.mean = np.zeros((self.dim,), np.float32)
        m = int(codes_dev.shape[0])
        if n_valid is None:
            n_valid = m
        if m != len(ids) or codes_dev.shape[1] != self.dim:
            raise ValueError(f"codes {tuple(codes_dev.shape)} do not match {len(ids)} ids "
                             f"x dim {self.dim}")
        self._grow_to(self.count + _bucket_rows(m) + 1)
        lo = self.count
        if host_codes is not None and host_scales is not None:
            self._sh_rows[lo : lo + n_valid] = host_codes[:n_valid]
            self._sh_scales[lo : lo + n_valid] = host_scales[:n_valid]
        else:
            self._sh_valid = False  # rows exist only on the device now
        _put(self.buf, lo, codes_dev[:n_valid])
        _put(self.scales, lo, scales_dev[:n_valid])
        if self.refine:
            if resid_dev is not None:
                _put(self.rbuf, lo, resid_dev[:n_valid])
                _put(self.rbuf_scales, lo, resid_scales_dev[:n_valid])
            if host_resid is not None and host_resid_scales is not None:
                self._sh_resid[lo : lo + n_valid] = host_resid[:n_valid]
                self._sh_resid_scales[lo : lo + n_valid] = host_resid_scales[:n_valid]
        self.alive[lo : lo + n_valid] = 1.0
        for i, sid in enumerate(ids[:n_valid]):
            self._id_to_row[sid] = lo + i
        self.ids.extend(ids[:n_valid])
        self.count = lo + n_valid

    def delete(self, ids: list[str]) -> int:
        """Tombstone rows by id. Compacts when >25% of rows are dead."""
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters
        removed = 0
        alive = self.alive.cpu().numpy().copy()
        for sid in ids:
            row = self._id_to_row.pop(sid, None)
            if row is not None and alive[row] > 0:
                alive[row] = 0.0
                self._dead_rows.add(row)
                removed += 1
        if removed:
            self.alive.copy_(torch.from_numpy(alive))
            self.dead += removed
            if self.dead * 4 > max(self.count, 1):
                self.compact()
        return removed

    def delete_all(self) -> None:
        self.count = 0
        self.dead = 0
        self.ids = []
        self._id_to_row = {}
        self._alloc(self.capacity)
        self._dead_rows = set()
        self.mean = None  # re-pinned at the next ingest
        # Row numbering restarts: the next save() rewrites from scratch.
        self._generation += 1

    def _raw_rows(self) -> np.ndarray:
        """Live-prefix rows in storage precision (int8 codes or float32),
        from the host shadow when valid, else one copy of the device buffer
        (rows from add_quantized)."""
        if self._sh_valid:
            return self._sh_rows[: self.count]
        src = self.buf8 if self.dtype == "int4" else self.buf
        return src[: self.count].cpu().numpy()

    def _raw_scales(self) -> np.ndarray | None:
        if self.dtype not in _QUANTIZED:
            return None
        if self._sh_valid:
            return self._sh_scales[: self.count]
        return self.scales[: self.count].cpu().numpy()

    def _raw_resid(self) -> tuple[np.ndarray | None, np.ndarray | None]:
        """Live-prefix residual codes and scales (refine), shadow first."""
        if not self.refine:
            return None, None
        if self._sh_valid:
            return self._sh_resid[: self.count], self._sh_resid_scales[: self.count]
        return (self.rbuf[: self.count].cpu().numpy(),
                self.rbuf_scales[: self.count].cpu().numpy())

    def _dequantized(self) -> np.ndarray:
        """Live-prefix vectors as float32 in raw space (decoded rows +
        mean), for compaction. The residual codes restore ~14-bit fidelity
        (re-quantizing a coarse-only decode would compound rounding error
        every cycle)."""
        raw = self._raw_rows()
        scales = self._raw_scales()
        out = raw.astype(np.float32)
        if scales is not None:
            out = out * scales[:, None]
        rq, rs = self._raw_resid()
        if rq is not None:
            out = out + rq.astype(np.float32) * rs[:, None]
        if self.mean is not None and self.mean.any():
            out = out + self.mean
        return out

    def compact(self) -> None:
        """Drop tombstoned rows and repack (host-side; O(count))."""
        alive = self.alive[: self.count].cpu().numpy() > 0
        keep = np.nonzero(alive)[0]
        vecs = self._dequantized()[keep]
        kept_ids = [self.ids[i] for i in keep]
        # Keep an externally pinned mean: the re-add re-centres against it.
        kept_mean = self.mean
        self.delete_all()
        if kept_mean is not None and kept_mean.any():
            self.mean = kept_mean.copy()
        if len(kept_ids):
            self.add(vecs, kept_ids)

    # -- search ---------------------------------------------------------------

    def scan_block_n(self) -> int:
        """The scan's block width, as memex_tpu picks it: it sets the bank
        widths of the quantized scans (K2 4 x 128 slots, K3 up to 8 x 128
        from block_n, int4 up to 8 or 16 x 128)."""
        if self.dtype == "int4" or self.query_quantize:
            return min(32768, self.capacity)
        return min(self.block_n, self.capacity)

    def _plain(self, q, k_eff: int, k_ret: int, exact: bool):
        """The plain scan (int4 scores from its int8 copy), then the rerank
        when one is due."""
        src = self.buf8 if self.dtype == "int4" else self.buf
        vals, idx = _search_plain(src, self.scales, self.alive, self.count, q, k_ret,
                                  exact=exact)
        if self.rerank and k_ret > k_eff:
            vals, idx = _exact_flat_rerank(src, self.scales, q, vals, idx, k_eff,
                                           rbuf=self.rbuf, rbuf_scales=self.rbuf_scales)
        return vals, idx

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        """[Q, dim] unit queries -> per-query [(id, cosine_similarity)]."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if self.count == 0:
            return [[] for _ in range(queries.shape[0])]
        k_eff = min(k, self.count)
        # Rerank over-fetch: retrieve a wider candidate set, re-score it.
        k_ret = min(max(k_eff, self.rerank), self.count) if self.rerank else k_eff
        # The fused scan's candidate list is at most 128 wide; wider
        # requests take the plain path. With tombstones a shortfall falls
        # back to the plain path below.
        use_fused = self.use_fused and k_ret <= 128
        kk = min(max(4 * k_eff, k_ret), 128)
        # alive rides into the scan only when tombstones exist.
        alive_arg = self.alive if self.dead else None
        exact = self.scan_precision == "highest"
        q = torch.from_numpy(queries).to(self.device)
        bn = self.scan_block_n()
        if use_fused and self.rerank and k_ret > k_eff:
            if self.dtype == "int4":
                kk_arg, deferred = _int4_rerank_depth(k_ret), _int4_deferred(q.shape[0])
            else:
                kk_arg, deferred = kk, False
            vals, idx = _search_rerank_fused(
                self.buf, self.scales, self.buf8, self.rbuf, self.rbuf_scales, alive_arg,
                self.count, q, k_eff, k_ret, kk_arg, bn, self.query_quantize, deferred,
                self.dtype, exact)
        elif use_fused and self.dtype == "int4":
            vals, idx = _search_masked_fused_int4(
                self.buf, self.scales, self.buf8, alive_arg, self.count, q, k_ret,
                block_n=bn, rerank=_int4_rerank_depth(k_ret),
                deferred=_int4_deferred(q.shape[0]))
        elif use_fused and self.dtype == "int8":
            vals, idx = _search_masked_fused_int8(
                self.buf, self.scales, alive_arg, self.count, q, k_ret, kk=kk, block_n=bn,
                qquant=self.query_quantize)
        elif use_fused:
            vals, idx = _search_masked_fused(self.buf, alive_arg, self.count, q, k_ret,
                                             kk=kk, exact=exact, keep2=exact)
        else:
            vals, idx = self._plain(q, k_eff, k_ret, exact)
        # Centred rows: restore true cosines with the query-constant q.mean.
        off = None
        if self.mean is not None and self.mean.any():
            off = queries @ self.mean
        out = self._hits_from(vals.cpu().numpy(), idx.cpu().numpy(), queries.shape[0], off)
        if use_fused and self.dead:
            # Shortfall: tombstones crowded the candidate bank. Re-run on
            # the plain path, which masks dead rows before its top-k.
            expect = min(k_eff, self.count - self.dead)
            if any(len(h) < expect for h in out):
                logger.info("fused search shortfall under deletes; exact rerun")
                vals, idx = self._plain(q, k_eff, k_ret, exact)
                out = self._hits_from(vals.cpu().numpy(), idx.cpu().numpy(),
                                      queries.shape[0], off)
        return out

    def _hits_from(self, vals, idx, q_n: int,
                   off: np.ndarray | None = None) -> list[list[tuple[str, float]]]:
        out = []
        for qi in range(q_n):
            hits = []
            for v, r in zip(vals[qi], idx[qi]):
                if v <= -1e29 or r >= self.count:
                    continue
                hits.append((self.ids[r],
                             float(v) + (float(off[qi]) if off is not None else 0.0)))
            out.append(hits)
        return out

    # -- persistence ----------------------------------------------------------
    #
    # Format v2 (incremental), shared with memex_tpu: `{path}.meta.json`
    # lists immutable row segments (`{path}.seg****.****.npz`, each a
    # contiguous run of stored rows in storage precision -- int8 codes and
    # scales, plus residual codes and scales for refine, or float32 rows --
    # with their ids) and the dead row indices since the last full rewrite.
    # A checkpoint after an ingest appends one segment; a compaction or
    # clear rewrites from scratch. int4 segments hold the int8 codes; the
    # packed rows are re-derived on load.

    def _write_meta(self, path: str, meta: dict) -> None:
        if self.mean is not None:
            # Presence means "pinned": a reload never re-pins a different
            # centre over the stored rows (a pinned zero mean included).
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        os.replace(tmp, path + ".meta.json")  # atomic vs crash mid-write

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not self._sh_valid and os.environ.get("MEMEX_CKPT_DEVICE_BASE") != "1":
            # Rows from add_quantized have no host shadow. SQL is the
            # durable source of truth, so record the skip (as memex_tpu
            # does) and let load() flag the index for recovery instead of
            # copying the device buffers.
            self.remove_checkpoint(path)
            self._write_meta(path, {"format": 2, "dim": self.dim, "dtype": self.dtype,
                                    "segments": [], "dead_ids": [], "rows_skipped": True})
            self._ckpt_path = path
            self._segments = []
            self._saved_count = 0
            return
        full = (path != self._ckpt_path or self._generation != self._ckpt_gen
                or not os.path.exists(path + ".meta.json"))
        if full:
            self.remove_checkpoint(path)  # clear stale segments
            self._segments = []
            self._saved_count = 0
            self._ckpt_path = path
            self._ckpt_gen = self._generation
        if self.count > self._saved_count:
            a, b = self._saved_count, self.count
            name = (f"{os.path.basename(path)}.seg{self._ckpt_gen % 10000:04d}"
                    f".{len(self._segments):04d}.npz")
            arrs: dict[str, np.ndarray] = {"ids": np.asarray(self.ids[a:b])}
            rows = self._raw_rows()[a:b]
            scales = self._raw_scales()
            if scales is not None:
                arrs["codes"] = rows
                arrs["scales"] = scales[a:b]
            else:
                arrs["vectors"] = rows.astype(np.float32)
            if self.refine:
                rq, rs = self._raw_resid()
                arrs["rcodes"] = rq[a:b]
                arrs["rscales"] = rs[a:b]
            np.savez(os.path.join(os.path.dirname(path) or ".", name), **arrs)
            self._segments.append(name)
            self._saved_count = b
        self._write_meta(path, {
            "format": 2,
            "dim": self.dim,
            "dtype": self.dtype,
            "refine": self.refine,
            "segments": self._segments,
            "dead_rows": sorted(self._dead_rows),
        })

    def _install_prequantized(self, codes: np.ndarray, scales: np.ndarray, ids: list[str],
                              rcodes: np.ndarray | None = None,
                              rscales: np.ndarray | None = None) -> None:
        """Bulk insert of already-int8-quantized rows (checkpoint restore):
        keeps the stored codes exactly. int4 re-derives its packed rows from
        the int8 codes."""
        m = codes.shape[0]
        if m == 0:
            return
        self._grow_to(self.count + _bucket_rows(m) + 1)
        lo = self.count
        self._sh_rows[lo : lo + m] = codes
        self._sh_scales[lo : lo + m] = scales
        if self.dtype == "int4":
            _put(self.buf, lo, pack_int4_from_int8(codes))
            _put(self.buf8, lo, codes)
        else:
            _put(self.buf, lo, codes)
        _put(self.scales, lo, np.asarray(scales, np.float32))
        if self.refine and rcodes is not None:
            self._sh_resid[lo : lo + m] = rcodes
            self._sh_resid_scales[lo : lo + m] = rscales
            _put(self.rbuf, lo, rcodes)
            _put(self.rbuf_scales, lo, np.asarray(rscales, np.float32))
        self.alive[lo : lo + m] = 1.0
        for i, sid in enumerate(ids):
            self._id_to_row[sid] = lo + i
        self.ids.extend(ids)
        self.count = lo + m

    @classmethod
    def load(cls, path: str, **kw) -> "FlatIndex":
        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        kw.setdefault("dtype", meta.get("dtype", "float32"))
        kw.setdefault("refine", meta.get("refine", False))
        if meta.get("format") != 2:  # legacy single-npz checkpoints
            vectors = np.load(path + ".npz")["vectors"]
            idx = cls(dim=meta["dim"], capacity=max(MIN_CAPACITY, len(meta["ids"]) + 1), **kw)
            if len(meta["ids"]):
                idx.add(vectors, meta["ids"])
            return idx
        if meta.get("rows_skipped"):
            idx = cls(dim=meta["dim"], **kw)
            if "mean" in meta:
                idx.mean = np.asarray(meta["mean"], np.float32)
            idx.needs_recovery = True
            return idx
        dead_rows = set(meta.get("dead_rows", []))
        dead_ids = set(meta.get("dead_ids", []))  # older checkpoints
        base = os.path.dirname(path) or "."
        ids_l, rows_l, scales_l, rcodes_l, rscales_l = [], [], [], [], []
        for name in meta["segments"]:
            arrs = np.load(os.path.join(base, name))
            ids_l.append(arrs["ids"])
            if "codes" in arrs:
                rows_l.append(arrs["codes"])
                scales_l.append(arrs["scales"])
            else:
                rows_l.append(arrs["vectors"])
            if "rcodes" in arrs:
                rcodes_l.append(arrs["rcodes"])
                rscales_l.append(arrs["rscales"])
        n_total = sum(len(a) for a in ids_l)
        idx = cls(dim=meta["dim"], capacity=max(MIN_CAPACITY, n_total + 1), **kw)
        if "mean" in meta:
            # Before the rows: stored rows are centred at exactly this mean.
            idx.mean = np.asarray(meta["mean"], np.float32)
        elif n_total:
            # Pre-centering checkpoint: rows are raw, pin zero.
            idx.mean = np.zeros((idx.dim,), np.float32)
        if n_total:
            ids_arr = np.concatenate(ids_l)
            rows = np.concatenate(rows_l)
            if dead_rows:
                # Segments are contiguous row runs: the concatenation index
                # is the row index, so this drops exactly the dead copies.
                keep = np.ones((n_total,), bool)
                keep[[r for r in dead_rows if 0 <= r < n_total]] = False
            elif dead_ids:
                keep = ~np.isin(ids_arr, sorted(dead_ids))
            else:
                keep = slice(None)
            kept_ids = [str(s) for s in ids_arr[keep]]
            if scales_l:
                has_resid = idx.refine and len(rcodes_l) == len(meta["segments"])
                idx._install_prequantized(
                    rows[keep], np.concatenate(scales_l)[keep], kept_ids,
                    rcodes=np.concatenate(rcodes_l)[keep] if has_resid else None,
                    rscales=np.concatenate(rscales_l)[keep] if has_resid else None)
            elif kept_ids:
                # Stored rows are already centred: install without
                # re-subtracting the mean.
                kept_rows = np.asarray(rows[keep], np.float32)
                idx._grow_to(idx.count + len(kept_ids) + 1)
                for i in range(0, len(kept_ids), _ADD_CHUNK):
                    idx._add_screened(kept_rows[i : i + _ADD_CHUNK],
                                      kept_ids[i : i + _ADD_CHUNK], precentered=True)
        if not dead_rows and not dead_ids:
            # Resume the segment log: the next save() appends.
            idx._ckpt_path = path
            idx._ckpt_gen = idx._generation
            idx._segments = list(meta["segments"])
            idx._saved_count = idx.count
        return idx

    @classmethod
    def exists(cls, path: str) -> bool:
        if not os.path.exists(path + ".meta.json"):
            return False
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return False
        if meta.get("format") == 2:
            return True
        return os.path.exists(path + ".npz")

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        """Delete every file of the checkpoint at `path`."""
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                segs = json.load(fh).get("segments", [])
        except (OSError, json.JSONDecodeError):
            segs = []
        base = os.path.dirname(path) or "."
        for name in segs:
            try:
                os.remove(os.path.join(base, name))
            except FileNotFoundError:
                pass
        for suffix in (".npz", ".meta.json"):
            try:
                os.remove(path + suffix)
            except FileNotFoundError:
                pass
