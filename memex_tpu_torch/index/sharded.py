"""ShardedFlatIndex: the flat index with its rows spread over a list of
devices (port of memex_tpu/index/sharded.py).

memex_tpu partitions the corpus over a mesh axis and searches it as one
SPMD program: every device scores its [cap, D] block against the
replicated queries with FlatIndex's fused scan, and an `all_gather` merges
the per-shard top-k. The port keeps that model on one controller: shard p
lives on devices[p] (a list that may repeat a device), a search launches
every shard's scan before it fetches anything, and the shards' candidates
merge on the lead device (parallel/collectives.py). The scan per shard is
K1 (float32/bfloat16), K2 (int8), K3 (int8 with query_quantize=False) or
K4 + its int8 rerank (int4), with memex_tpu's bank widths.

Under a process group (`group=`, one controller a rank, as memex_tpu after
`init_multihost`) `devices` are this rank's own shards and global shard g
is rank * P_local + p (parallel/mesh.py::shard_layout). Every rank is
called with the same arguments in the same order, so the host state (fill
levels, id tables, host shadow, tombstones) is the same on every rank;
device buffers exist only for the rank's own shards, and every write and
scan touches only those. A search all_gathers the ranks' candidates into
one merge, so every rank returns the same hits, and every branch after it
reads only the merged hits. Every rank saves its own copy of the same
checkpoint files, as every memex_tpu process does.

Layout, per shard (memex_tpu's global arrays, cut at shard boundaries):
  bufs[p]    [cap, D] rows (int4: [cap, D/2] packed nibbles, row-major
             where memex_tpu keeps them transposed)
  buf8s[p]   [cap, D] int8 rerank copy (int4 only)
  scales[p]  [cap] per-row scales (int8, int4)
  alive[p]   [cap] tombstone mask

Row r of shard p is global row p * cap + r; the host id table, the host
shadow of the stored rows (checkpoints and compaction read it, not the
device) and the checkpoint files are keyed by global row, in memex_tpu's
`.mesh` format, so either package restores the other's checkpoints.
Ingest water-fills the shards' fill levels exactly as memex_tpu does.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..log import get_logger
from ..ops.fused_topk import np_quantize_rows_int4
from ..parallel.collectives import merge_topk_across
from ..parallel.mesh import replicate, shard_layout
from .flat import FlatIndex, FlatRows, _put, scan_rows

logger = get_logger(__name__)

# Bulk-add streaming chunk (rows), as memex_tpu's.
_ADD_CHUNK = 1 << 17
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
           "int4": torch.int8}
_QUANTIZED = ("int8", "int4")


def write_atomically(file: str, write) -> None:
    """write(fh) into a name of this process's own, then rename it to
    `file`: ranks of a process group that share a directory each write
    their copy of the same file, and none reads another's half-written."""
    tmp = f"{file}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, file)


class ShardedFlatIndex:
    """Exact index over len(devices) shards with a top-k merge on the lead
    device. Same hits as FlatIndex on one shard; P shards scan in parallel
    where they sit on P cards."""

    def __init__(self, dim: int, devices: list, capacity_per_shard: int = 2048,
                 use_fused: bool | None = None, block_n: int = 1024,
                 dtype: str = "float32", query_quantize: bool = True, group=None):
        """devices: one entry per shard (torch devices or their names);
        under a process group `group`, this rank's own shards.
        capacity_per_shard rounds up to a power of two >= block_n.
        use_fused defaults to True when the lead device is a CUDA card."""
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        if dtype == "int4" and dim % 2:
            raise ValueError(f"int4 packing needs an even dim, got {dim}")
        if not devices:
            raise ValueError("a sharded index needs at least one device")
        self.group = group
        # Global shard list (None: another rank's shard) and this
        # controller's own shards in it.
        self.devices, self.own = shard_layout(devices, group)
        self.lead = self.devices[self.own[0]]
        self.dim = dim
        self.dtype = dtype
        self.query_quantize = query_quantize
        self.P = len(self.devices)
        cap = max(block_n, int(capacity_per_shard))
        self.cap = 1 << (cap - 1).bit_length()
        self.use_fused = self.lead.type == "cuda" if use_fused is None else use_fused
        self._sh_dtype = np.int8 if dtype in _QUANTIZED else np.float32
        self._generation = 0
        self._ckpt_path: str | None = None
        self._ckpt_gen = -1
        self._segments: list[str] = []
        self._reset()

    def _reset(self) -> None:
        """Zeroed own shards at self.cap (None for another rank's), empty id
        tables and host shadow."""
        cap, quant = self.cap, self.dtype in _QUANTIZED

        def each(shape, dtype):
            return [None if d is None else torch.zeros(shape, dtype=dtype, device=d)
                    for d in self.devices]

        width = self.dim // 2 if self.dtype == "int4" else self.dim
        self.bufs = each((cap, width), _DTYPES[self.dtype])
        self.buf8s = each((cap, self.dim), torch.int8) if self.dtype == "int4" else None
        self.scales = each((cap,), torch.float32) if quant else None
        self.alive = each((cap,), torch.float32)
        self.counts = [0] * self.P  # host-side fill levels
        self.dead = 0
        self.ids: dict[int, str] = {}  # global row -> id
        self._id_to_row: dict[str, int] = {}
        # Write-through host shadow, rows in storage precision by global row
        # (int4: the int8 rerank copy). np.zeros is lazily backed.
        total = self.P * cap
        self._sh_rows = np.zeros((total, self.dim), self._sh_dtype)
        self._sh_scales = np.ones((total,), np.float32) if quant else None
        self._unsaved: list[tuple[int, str]] = []  # (global row, id) since the last save
        # Dead rows by global row (stable within a generation), not by id.
        self._dead_rows: set[int] = set()

    @property
    def count(self) -> int:
        return len(self._id_to_row)

    def _quantize(self, block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Rows in storage precision (bfloat16 rounded to nearest even, as
        float32 values) and their scales (ones for the float tiers)."""
        if self.dtype in _QUANTIZED:
            from ..native_lib import np_quantize_rows_int8

            return np_quantize_rows_int8(block)
        if self.dtype == "bfloat16":
            block = torch.from_numpy(block).to(torch.bfloat16).float().numpy()
        return block.astype(np.float32), np.ones((block.shape[0],), np.float32)

    # -- mutation -------------------------------------------------------------

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[0] != len(ids) or vectors.shape[1] != self.dim:
            raise ValueError(f"vectors {vectors.shape} do not match {len(ids)} ids x "
                             f"dim {self.dim}")
        if len(set(ids)) < len(ids):
            # Intra-batch duplicates: keep the last occurrence per id.
            last = {sid: i for i, sid in enumerate(ids)}
            pick = sorted(last.values())
            vectors = vectors[pick]
            ids = [ids[i] for i in pick]
        if any(sid in self._id_to_row for sid in ids):
            # Idempotent re-add: insert only new ids.
            fresh = [i for i, sid in enumerate(ids) if sid not in self._id_to_row]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        for i in range(0, vectors.shape[0], _ADD_CHUNK):
            self._add_screened(vectors[i : i + _ADD_CHUNK], ids[i : i + _ADD_CHUNK])

    def _add_screened(self, vectors: np.ndarray, ids: list[str]) -> None:
        m = vectors.shape[0]
        if m > self.P * self.cap - sum(self.counts):
            self._grow_for(m)
        alloc = self._waterfill(m)
        qall, sall = self._quantize(vectors)
        pall = np_quantize_rows_int4(vectors)[0] if self.dtype == "int4" else None
        cursor = 0
        for s, take in enumerate(alloc):
            if not take:
                continue
            lo, sl = self.counts[s], slice(cursor, cursor + take)
            base = s * self.cap + lo
            grows = range(base, base + take)
            sids = ids[sl]
            self.ids.update(zip(grows, sids))
            self._id_to_row.update(zip(sids, grows))
            self._sh_rows[base : base + take] = qall[sl]
            if self._sh_scales is not None:
                self._sh_scales[base : base + take] = sall[sl]
            self._unsaved.extend(zip(grows, sids))
            if self.bufs[s] is not None:  # an own shard: write its device copy
                if self.scales is not None:
                    _put(self.scales[s], lo, sall[sl])
                if self.dtype == "int4":
                    _put(self.bufs[s], lo, pall[sl])
                    _put(self.buf8s[s], lo, qall[sl])
                else:
                    _put(self.bufs[s], lo, qall[sl])
                self.alive[s][lo : lo + take] = 1.0
            self.counts[s] += take
            cursor += take

    def _grow_for(self, m: int) -> None:
        """Double capacity_per_shard until m more rows fit: re-add the live
        rows from the host shadow at the new capacity (compacting
        tombstones; global rows renumber, so the next save rewrites)."""
        rows = sorted(self.ids.items())
        sids = [s for _, s in rows]
        vecs = self.rows_f32([g for g, _ in rows])
        new_cap = self.cap
        while self.P * new_cap - len(rows) < m:
            new_cap *= 2
        logger.info("sharded index grow %d -> %d rows/shard (%d live rows)",
                    self.cap, new_cap, len(rows))
        self.cap = new_cap
        self.delete_all()
        if sids:
            self.add(vecs, sids)

    def _waterfill(self, m: int) -> list[int]:
        """Rows per shard for m new rows: level the fills toward the mean,
        capacity-bounded, leftovers into free capacity (memex_tpu's
        placement, row for row: global rows key the checkpoint)."""
        alloc = [0] * self.P
        rem = m
        order = sorted(range(self.P), key=lambda s: self.counts[s])
        per = -(-(sum(self.counts) + m) // self.P)  # target level
        for s in order:
            take = min(self.cap - self.counts[s], max(0, per - self.counts[s]), rem)
            alloc[s] = take
            rem -= take
        for s in order:
            if rem == 0:
                break
            extra = min(self.cap - self.counts[s] - alloc[s], rem)
            alloc[s] += extra
            rem -= extra
        if rem:
            raise RuntimeError(f"{rem} rows found no free shard capacity")
        return alloc

    def delete(self, ids: list[str]) -> int:
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters
        grows = []
        for sid in ids:
            row = self._id_to_row.pop(sid, None)
            if row is not None:
                self.ids.pop(row, None)
                self._dead_rows.add(row)
                grows.append(row)
        if grows:
            g = np.asarray(grows, np.int64)
            for s in np.unique(g // self.cap):
                if self.alive[s] is None:
                    continue  # another rank's shard
                local = torch.from_numpy(g[g // self.cap == s] % self.cap)
                self.alive[s][local.to(self.devices[s])] = 0.0
            self.dead += len(grows)
            if self.dead * 4 > max(self.count, 1):
                self.compact()
        return len(grows)

    def compact(self) -> None:
        """Repack the live rows (host shadow re-add), reclaiming tombstoned
        capacity; runs past 25% dead rows."""
        rows = sorted(self.ids.items())
        vecs = self.rows_f32([g for g, _ in rows])
        self.delete_all()
        if rows:
            self.add(vecs, [s for _, s in rows])

    def delete_all(self) -> None:
        self._reset()
        self._generation += 1  # row numbering restarted

    def rows_f32(self, grows: list[int]) -> np.ndarray:
        """The given global rows as float32 from the host shadow (int8 codes
        times their scales)."""
        if not len(grows):
            return np.zeros((0, self.dim), np.float32)
        sel = np.asarray(grows)
        raw = self._sh_rows[sel].astype(np.float32)
        if self._sh_scales is not None:
            raw = raw * self._sh_scales[sel][:, None]
        return raw

    # -- search ---------------------------------------------------------------

    def _shard_scan(self, s: int, q: torch.Tensor, kk: int, fused: bool, masked: bool):
        """Shard s's top-kk: (vals, local row) [Q, kk], with the call
        parameters of memex_tpu's `make_search_fn` (fixed K2 and K3 banks,
        the candidates left for the merge). The tombstone mask rides into a
        fused scan only when `masked` (the index has tombstones); the plain
        scan masks it before its top-k. Launches only: no host sync."""
        rows = FlatRows(self.dtype, self.query_quantize, self.counts[s], self.bufs[s],
                        None if self.scales is None else self.scales[s],
                        None if self.buf8s is None else self.buf8s[s])
        return scan_rows(rows, q, kk, alive=self.alive[s], masked=masked, fused=fused,
                         block_n=min(32768, self.cap), kk=kk, fixed_banks=True, select=False)

    def _search_shards(self, queries: np.ndarray, k: int, fused: bool):
        """Every own shard's scan, then the merge on the lead device (across
        the group's ranks under a process group): (vals, global row) [Q, k]
        tensors there, not yet fetched."""
        kk = min(4 * k, 128, self.cap)
        # The fused banks are <= 128 wide: a deeper k takes the plain scan,
        # with kk widened to cover it.
        fused = fused and k <= kk
        if not fused:
            kk = min(max(kk, k), self.cap)
        masked = bool(self.dead)
        # Queries reach every device first: a blocking host->device copy
        # waits for its device's stream, so it must not follow a launch.
        q = replicate(torch.from_numpy(queries), [self.devices[s] for s in self.own])
        vals, gidx = [], []
        for j, s in enumerate(self.own):
            v, i = self._shard_scan(s, q[j], kk, fused, masked)
            vals.append(v)
            gidx.append(i.long() + s * self.cap)
        return merge_topk_across(vals, gidx, k, self.lead, self.group)

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        total = self.count
        if total == 0:
            return [[] for _ in range(queries.shape[0])]
        k_eff = min(k, total)
        out = self._hits_from(*self._search_shards(queries, k_eff, self.use_fused))
        if self.use_fused and self.dead:
            # Shortfall under tombstones: dead rows can crowd the fused
            # banks; the plain scan masks them before its top-k. The hits
            # are the merged ones, the same on every rank.
            if any(len(h) < k_eff for h in out):
                logger.info("sharded fused shortfall under deletes; exact rerun")
                out = self._hits_from(*self._search_shards(queries, k_eff, False))
        return out

    def _hits_from(self, vals: torch.Tensor, idx: torch.Tensor) -> list[list[tuple[str, float]]]:
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        out = []
        for v_row, i_row in zip(vals, idx):
            hits = []
            for v, r in zip(v_row, i_row):
                sid = self.ids.get(int(r))
                if v <= -1e29 or sid is None:
                    continue
                hits.append((sid, float(v)))
            out.append(hits)
        return out

    # -- persistence (FlatIndex's segment-log format, rows keyed by global row)

    def save(self, path: str) -> None:
        """Incremental checkpoint from the host shadow: appends the rows
        added since the last save; a compaction or clear rewrites. Under a
        process group every rank writes its own copy of the same files from
        its replicated shadow, as every memex_tpu process does, and meets no
        other rank on the way."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        full = (path != self._ckpt_path or self._generation != self._ckpt_gen
                or not os.path.exists(path + ".meta.json"))
        if full:
            self.remove_checkpoint(path)
            self._segments = []
            self._ckpt_path = path
            self._ckpt_gen = self._generation
            self._unsaved = sorted(self.ids.items())  # all live rows
            self._dead_rows = set()  # a full rewrite holds live rows only
        pending = [(g, s) for g, s in self._unsaved if self.ids.get(g) == s]
        if pending:
            name = (f"{os.path.basename(path)}.seg{self._ckpt_gen % 10000:04d}"
                    f".{len(self._segments):04d}.npz")
            grows = np.asarray([g for g, _ in pending])
            arrs: dict[str, np.ndarray] = {
                "ids": np.asarray([s for _, s in pending]),
                "grows": grows.astype(np.int64),
            }
            if self._sh_scales is not None:
                arrs["codes"] = self._sh_rows[grows]
                arrs["scales"] = self._sh_scales[grows]
            else:
                arrs["vectors"] = self._sh_rows[grows].astype(np.float32)
            write_atomically(os.path.join(os.path.dirname(path) or ".", name),
                             lambda fh: np.savez(fh, **arrs))
            self._segments.append(name)
        self._unsaved = []
        meta = {
            "format": 2,
            "dim": self.dim,
            "dtype": self.dtype,
            "segments": self._segments,
            "dead_rows": sorted(int(g) for g in self._dead_rows),
        }
        write_atomically(path + ".meta.json", lambda fh: fh.write(json.dumps(meta).encode()))

    def restore(self, path: str) -> int:
        """Re-add a checkpoint's rows into this (fresh) index through the
        water-filling add (every rank reads the files); returns the rows
        restored. The segment log is not resumed (the re-add renumbers
        global rows): the next save rewrites from the host shadow."""
        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        if meta.get("format") != 2:  # legacy single-npz
            ids = meta["ids"]
            if ids:
                self.add(np.load(path + ".npz")["vectors"], ids)
            return len(ids)
        dead_rows = set(meta.get("dead_rows", []))
        dead_ids = set(meta.get("dead_ids", []))  # older checkpoints
        base = os.path.dirname(path) or "."
        restored = 0
        for name in meta["segments"]:
            arrs = np.load(os.path.join(base, name))
            ids_arr = arrs["ids"]
            if "codes" in arrs:
                vecs = arrs["codes"].astype(np.float32) * arrs["scales"][:, None]
            else:
                vecs = arrs["vectors"]
            if dead_rows and "grows" in arrs:
                keep = ~np.isin(arrs["grows"], sorted(dead_rows))
                ids_arr, vecs = ids_arr[keep], vecs[keep]
            elif dead_ids:
                keep = ~np.isin(ids_arr.astype(str), sorted(dead_ids))
                ids_arr, vecs = ids_arr[keep], vecs[keep]
            if len(ids_arr):
                self.add(vecs, [str(s) for s in ids_arr])
                restored += len(ids_arr)
        return restored

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        FlatIndex.remove_checkpoint(path)  # same file layout
