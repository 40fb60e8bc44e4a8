"""FlatIndex: exact brute-force vector index resident on one device.

Port of memex_tpu/index/flat.py, float32 and bfloat16 tiers. The rows live
in one power-of-two-capacity buffer on the device; `count` and the
tombstone mask `alive` select the live prefix, so ingest and search never
reshape anything until a capacity doubling. Search runs the fused
score+top-k scan (ops/fused_topk.py: the CUDA kernel for a buffer on the
card) or, where the fused path does not apply, the plain two-stage scan.

Stores centre their rows: the mean of the first ingest is pinned and the
buffer holds `v - mean`; search ranks by the residual score and adds the
query-constant `q . mean` back after the top-k. The host shadow mirrors
every stored row, so save() and compact() read no device bytes. The
checkpoint format (v2, incremental segments) is memex_tpu's, byte for
byte, so either package loads the other's checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from memex_tpu.log import get_logger

from ..ops.fused_topk import fused_score_topk, scores_f32
from ..ops.topk import blockwise_topk, exact_topk

logger = get_logger(__name__)

MIN_CAPACITY = 2048
_ADD_BUCKETS = (8, 64, 256, 1024)
# Bulk-add streaming chunk (rows).
_ADD_CHUNK = 1 << 17
_NOT_PORTED = {
    "int8": "ROADMAP.md queue 1 item 3 (the int8 tier, kernels K2/K3)",
    "int4": "ROADMAP.md queue 1 item 10 (the int4 tier, kernel K4)",
    "refine": "ROADMAP.md queue 1 item 3 (refine stores belong to the int8/int4 tiers)",
}


def _bucket_rows(m: int) -> int:
    for b in _ADD_BUCKETS:
        if m <= b:
            return b
    return -(-m // _ADD_BUCKETS[-1]) * _ADD_BUCKETS[-1]


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


def _exact_flat_rerank(buf, queries, vals, idx, keep: int):
    """Re-score a coarse search's candidate rows in true float32 and keep
    the top `keep`. Sentinel candidates (vals <= -1e29) keep their
    sentinel. Returns (vals, idx) [Q, keep]."""
    rows = buf[idx.long()].float()  # [Q, kk, D]
    scores = scores_f32(queries[:, None, :], rows.transpose(1, 2), exact=True)[:, 0]
    scores = torch.where(vals > -1e29, scores, vals)
    top_v, top_j = exact_topk(scores, keep)
    return top_v, torch.gather(idx, 1, top_j.long())


def _search_rerank_fused(buf, alive, count: int, queries, k: int, k_ret: int,
                         kk: int, exact: bool, keep2: bool = True):
    """Coarse fused scan for k_ret candidates, then the exact rerank to k
    (memex_tpu composes both into one executable; here they are
    consecutive launches on one stream)."""
    vals, idx = _search_masked_fused(buf, alive, count, queries, k_ret, kk=kk,
                                     exact=exact, keep2=keep2)
    return _exact_flat_rerank(buf, queries, vals, idx, k)


def _search_plain(buf, alive, count: int, queries, k: int, exact: bool = False):
    """Non-fused scan (memex_tpu's `_search_xla`): the whole [Q, N] score
    matrix at the kernel's precision (bf16-rounded inputs, or float32 when
    exact), tombstones masked before an exact two-stage top-k, so it can
    never fall short of live hits."""
    scores = scores_f32(queries, buf.T, exact=exact)
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
        """dtype: "float32" or "bfloat16" storage. `rerank` re-scores the
        top-`rerank` scan candidates in true float32 (capped at 128, the
        candidate bank's ceiling). scan_precision="highest" (float32 only)
        scans in true float32 with the two-per-slot fold. use_fused
        defaults to True on a CUDA device. block_n and query_quantize are
        accepted, and ignored, so that memex_tpu store URIs carrying them
        still parse; the float tiers have no use for them."""
        if dtype in _NOT_PORTED:
            raise NotImplementedError(f"dtype={dtype!r} is not ported yet: {_NOT_PORTED[dtype]}")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {dtype!r}")
        if refine:
            raise NotImplementedError(f"refine=True is not ported yet: {_NOT_PORTED['refine']}")
        if scan_precision not in ("default", "highest"):
            raise ValueError(f"unknown scan_precision {scan_precision!r}")
        if scan_precision == "highest" and dtype != "float32":
            raise ValueError(f"scan_precision='highest' requires float32 storage, got {dtype}")
        self.device = torch.device(device)
        self.dim = dim
        self.dtype = dtype
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None  # None = not pinned yet
        self.rerank = None if rerank is None else min(int(rerank), 128)
        self.scan_precision = scan_precision
        capacity = max(MIN_CAPACITY, int(capacity))
        self.capacity = 1 << (capacity - 1).bit_length()  # power of two
        self.count = 0
        self.dead = 0
        self.use_fused = self.device.type == "cuda" if use_fused is None else use_fused
        self.ids: list[str] = []
        self._id_to_row: dict[str, int] = {}
        self._buf_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
        self.buf = torch.zeros((self.capacity, dim), dtype=self._buf_dtype, device=self.device)
        self.alive = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        # Write-through host shadow of the stored (centred) rows in float32.
        self._sh_rows = np.zeros((self.capacity, dim), np.float32)
        # Incremental-checkpoint state (see save()). Dead rows are tracked
        # by row index, stable within a generation.
        self._generation = 0
        self._dead_rows: set[int] = set()
        self._ckpt_path: str | None = None
        self._ckpt_gen = -1
        self._saved_count = 0
        self._segments: list[str] = []

    # -- mutation -------------------------------------------------------------

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        logger.info("flat index grow %d -> %d", self.capacity, new_cap)
        pad = new_cap - self.capacity
        self.buf = torch.cat([self.buf, torch.zeros((pad, self.dim), dtype=self._buf_dtype,
                                                    device=self.device)])
        self.alive = torch.cat([self.alive, torch.zeros((pad,), dtype=torch.float32,
                                                        device=self.device)])
        self._sh_rows = np.concatenate([self._sh_rows, np.zeros((pad, self.dim), np.float32)])
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
        lo, hi = self.count, self.count + m
        self._sh_rows[lo:hi] = resid
        # In place: memex_tpu donates the buffer to an XLA update-slice; here
        # the rows are written into the live buffer. A search launched
        # earlier on the same stream has already read them in stream order.
        self.buf[lo:hi] = torch.tensor(resid, dtype=torch.float32).to(
            self.device, self._buf_dtype)
        self.alive[lo:hi] = 1.0
        for i, sid in enumerate(ids):
            self._id_to_row[sid] = lo + i
        self.ids.extend(ids)
        self.count = hi

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
        self.buf = torch.zeros((self.capacity, self.dim), dtype=self._buf_dtype,
                               device=self.device)
        self.alive = torch.zeros((self.capacity,), dtype=torch.float32, device=self.device)
        self._sh_rows = np.zeros((self.capacity, self.dim), np.float32)
        self._dead_rows = set()
        self.mean = None  # re-pinned at the next ingest
        # Row numbering restarts: the next save() rewrites from scratch.
        self._generation += 1

    def _decoded_rows(self) -> np.ndarray:
        """Live-prefix vectors in raw space (stored rows + mean), from the
        host shadow."""
        out = self._sh_rows[: self.count]
        if self.mean is not None and self.mean.any():
            out = out + self.mean
        return out

    def compact(self) -> None:
        """Drop tombstoned rows and repack (host-side; O(count))."""
        alive = self.alive[: self.count].cpu().numpy() > 0
        keep = np.nonzero(alive)[0]
        vecs = self._decoded_rows()[keep]
        kept_ids = [self.ids[i] for i in keep]
        # Keep an externally pinned mean: the re-add re-centres against it.
        kept_mean = self.mean
        self.delete_all()
        if kept_mean is not None and kept_mean.any():
            self.mean = kept_mean.copy()
        if len(kept_ids):
            self.add(vecs, kept_ids)

    # -- search ---------------------------------------------------------------

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
        q = torch.tensor(queries).to(self.device)
        if use_fused and self.rerank and k_ret > k_eff:
            vals, idx = _search_rerank_fused(self.buf, alive_arg, self.count, q,
                                             k_eff, k_ret, kk, exact)
        elif use_fused:
            vals, idx = _search_masked_fused(self.buf, alive_arg, self.count, q,
                                             k_ret, kk=kk, exact=exact, keep2=exact)
        else:
            vals, idx = _search_plain(self.buf, self.alive, self.count, q, k_ret,
                                      exact=exact)
        if not use_fused and self.rerank and k_ret > k_eff:
            vals, idx = _exact_flat_rerank(self.buf, q, vals, idx, k_eff)
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
                vals, idx = _search_plain(self.buf, self.alive, self.count, q, k_ret,
                                          exact=exact)
                if self.rerank and k_ret > k_eff:
                    vals, idx = _exact_flat_rerank(self.buf, q, vals, idx, k_eff)
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
    # contiguous run of stored rows plus their ids) and the dead row
    # indices since the last full rewrite. A checkpoint after an ingest
    # appends one segment; a compaction or clear rewrites from scratch.

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
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
            np.savez(os.path.join(os.path.dirname(path) or ".", name),
                     ids=np.asarray(self.ids[a:b]), vectors=self._sh_rows[a:b])
            self._segments.append(name)
            self._saved_count = b
        meta = {
            "format": 2,
            "dim": self.dim,
            "dtype": self.dtype,
            "refine": False,
            "segments": self._segments,
            "dead_rows": sorted(self._dead_rows),
        }
        if self.mean is not None:
            # Presence means "pinned": a reload never re-pins a different
            # centre over the stored rows (a pinned zero mean included).
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        os.replace(tmp, path + ".meta.json")  # atomic vs crash mid-write

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
        dead_rows = set(meta.get("dead_rows", []))
        dead_ids = set(meta.get("dead_ids", []))  # older checkpoints
        base = os.path.dirname(path) or "."
        ids_l, rows_l = [], []
        for name in meta["segments"]:
            arrs = np.load(os.path.join(base, name))
            if "vectors" not in arrs:
                raise NotImplementedError(
                    f"segment {name} holds quantized codes: {_NOT_PORTED['int8']}")
            ids_l.append(arrs["ids"])
            rows_l.append(arrs["vectors"])
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
            if kept_ids:
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
