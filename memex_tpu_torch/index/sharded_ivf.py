"""ShardedIVFIndex: IVF partitions spread over a list of devices (port of
memex_tpu/index/sharded_ivf.py, the 10M-100M tier).

The k-means clusters are sharded contiguously: shard p owns clusters
[p * Cp, (p + 1) * Cp) and their [Cp, M, D] int8 bucket block on
devices[p]; the centroids are replicated. A search launches, for every
shard before it fetches anything: routing of the whole batch on the
shard's centroid copy (float32, top-nprobe, the margin prune), the probes
masked to the shard's own clusters and ordered actives-first on the
device, the batch-union scan (K5, ops/ivf_batch.py) over them, and with
refine a float32 rescore of the shard's own candidates. The shards'
candidates then merge on the lead device (parallel/collectives.py). Every
shard takes the batch kernel when the index is fused: a shape it cannot
take raises rather than falling back to the dense scan.

Streaming adds go to a ShardedFlatIndex spill (int8: K2); fold_spill()
streams them into free bucket slots, rebuild() retrains. Checkpoints are
memex_tpu's `.ivfmesh` format 2, so either package restores the other's.

Under a process group (`group=`, one controller a rank) global shard g is
rank * P_local + p and owns clusters [g * Cp, (g + 1) * Cp); each rank
holds only its own bucket blocks, launches only their scans, and the
ranks all_gather their candidates into one merge. What memex_tpu holds
replicated is the same on every rank: the centroids, the cluster
assignments behind the sizes and row ids, the fold's cluster choices and
the mean are derived once, on rank 0, and broadcast; the rest follows
from them and from the arguments, which every rank receives in the same
order. A gather of table rows (rebuild, save, calibration) sums the
ranks' own slots. Every rank saves its own copy of the same checkpoint.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..log import get_logger
from ..ops.fused_topk import scores_f32
from ..ops.ivf_batch import ivf_batch_topk
from ..ops.topk import blockwise_topk, exact_topk
from ..parallel.collectives import all_gather_cat, from_rank0, merge_topk_across, sum_across
from ..parallel.mesh import replicate, row_blocks, shard_layout
from .flat import FlatIndex
from .ivf import (_BLOCK, IVFIndex, _capacity_fill, _topk_clusters, bucket_pack_dest,
                  calibrate_operating_point, calibrate_prune_margin, kmeans_assign, kmeans_fit)
from .sharded import ShardedFlatIndex, write_atomically

logger = get_logger(__name__)

NEG_INF = -1e30


def _train_sample(n_valid: int, m: int, gen: torch.Generator) -> torch.Tensor:
    """Indices of the k-means training sample: m of the n_valid rows,
    without replacement, drawn by `gen` on its device."""
    return torch.randperm(n_valid, generator=gen, device=gen.device)[:m]


def _top_with_offset(merged: list[dict], off, k: int) -> list[list[tuple]]:
    """Top-k per query, the centered-storage q . mean added back (rank
    neutral: the offset is constant per query)."""
    out = []
    for qi, m in enumerate(merged):
        top = sorted(m.items(), key=lambda kv: -kv[1])[:k]
        if off is not None:
            o = float(off[qi])
            top = [(sid, v + o) for sid, v in top]
        out.append(top)
    return out


def _shard_mask(cent: torch.Tensor, q: torch.Tensor, nprobe: int, margin: float | None,
                lo: int, Cp: int) -> torch.Tensor:
    """[Cp] bool: the clusters [lo, lo + Cp) that some query of the batch
    probes. Routing is true float32 over all C centroids (top-nprobe, ties
    to the lower id); a probe trailing its query's best centroid score by
    more than `margin` is dropped (None keeps all)."""
    C = cent.shape[0]
    top_vals, probes = exact_topk(scores_f32(q, cent.T, exact=True), nprobe)
    # A Python scalar, not a tensor made from one: that would be a blocking
    # host->device copy, which waits for the earlier shards' launches.
    keep = top_vals >= top_vals[:, :1] - (4.0 if margin is None else margin)
    probes = torch.where(keep, probes.long(), C)
    local = torch.where((probes >= lo) & (probes < lo + Cp), probes - lo, Cp)
    mask = torch.zeros((Cp + 1,), dtype=torch.bool, device=q.device)
    mask[local.reshape(-1)] = True
    return mask[:Cp]


def _dense_topk(data, rscales, sizes, q, kk: int, mask=None):
    """Plain scan of a shard's whole table: bf16 inputs, float32
    accumulation, times the row scale; slots past their cluster's size
    (and, with `mask`, clusters outside it) score -1e30. Returns (vals,
    flat slot) [Q, kk], padded with -1e30 where the shard holds fewer."""
    Cp, M, D = data.shape
    scores = scores_f32(q, data.reshape(Cp * M, D).T, exact=False) * rscales.reshape(1, -1)
    col = torch.arange(Cp * M, device=data.device)
    cluster_of = col // M
    ok = col % M < sizes.long()[cluster_of]
    if mask is not None:
        ok &= mask[cluster_of]
    scores = torch.where(ok[None, :], scores, NEG_INF)
    vals, idx = blockwise_topk(scores, min(kk, Cp * M))
    if vals.shape[1] < kk:
        pad = kk - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad))
    return vals, idx.long()


def _flat(tables: list) -> list:
    """Per-shard [Cp, M, ...] tables viewed as [Cp * M, ...] (None stays
    None: another rank's shard)."""
    return [None if t is None else t.view(t.shape[0] * t.shape[1], *t.shape[2:])
            for t in tables]


class ShardedIVFIndex:
    """IVF over len(devices) cluster shards, int8 storage only (the tier
    exists to fit big corpora), with the top-k merge on the lead device."""

    def __init__(self, dim: int, devices: list, n_clusters: int = 256, nprobe: int = 32,
                 bucket_factor: float = 2.0, seed: int = 0, use_fused: bool | None = None,
                 prune_margin: float | None = None, rerank: int | None = None,
                 refine: bool = False, center: bool | None = None, group=None):
        """devices: one entry per shard; under a process group `group`, this
        rank's own shards. n_clusters rounds up to a multiple of the
        global shard count. refine keeps int8 codes of the quantization
        residual for a per-shard float32 rescore of each shard's
        candidates (rerank defaults to 256, capped at 512). use_fused
        defaults to True when the lead device is a CUDA card."""
        if not devices:
            raise ValueError("a sharded index needs at least one device")
        self.group = group
        # Global shard list (None: another rank's shard) and this
        # controller's own shards in it.
        self.devices, self.own = shard_layout(devices, group)
        self.lead = self.devices[self.own[0]]
        self.rank0 = group is None or dist.get_rank(group) == 0
        self.dim = dim
        self.P = len(self.devices)
        self.C = -(-n_clusters // self.P) * self.P
        self.Cp = self.C // self.P
        self.nprobe = min(nprobe, self.C)
        self.bucket_factor = bucket_factor
        self.seed = seed
        self.dtype = "int8"
        self.use_fused = self.lead.type == "cuda" if use_fused is None else use_fused
        self.prune_margin = prune_margin
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 256
        self.rerank = None if rerank is None else min(int(rerank), 512)
        # One mean for table and spill, pinned at the first host ingest
        # (device-built corpora pin zero).
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None
        self.centroids: torch.Tensor | None = None  # [C, D] on the lead device
        self._cent: list[torch.Tensor] = []         # its copy on each shard's device
        # Per shard: data [Cp, M, D] int8, rscales [Cp, M], sizes [Cp] int32,
        # rowids [Cp, M] int32 (index into `ids`, -1 where empty), and with
        # refine resid [Cp, M, D] int8, resid_scales [Cp, M]. None: no table.
        self.data: list[torch.Tensor] | None = None
        self.rscales: list[torch.Tensor] | None = None
        self.sizes: list[torch.Tensor] | None = None
        self.resid: list[torch.Tensor] | None = None
        self.resid_scales: list[torch.Tensor] | None = None
        self._rowids_dev: list[torch.Tensor] | None = None
        self._sizes_h: np.ndarray | None = None  # [C] host copy of the sizes
        self.rowids: np.ndarray | None = None    # [C, M] host cache of the rowids
        self.ids: list = []
        self.spill = ShardedFlatIndex(dim, [self.devices[p] for p in self.own], dtype="int8",
                                      use_fused=self.use_fused, group=group)
        self._deleted: set = set()
        self._live: set = set()
        self._ids_nulled = False  # an add() nulled stale table ids (delete -> re-add)
        # Set (never acted on) by search: a shortfall query was answered by
        # the exact pass and the table wants a rebuild.
        self.maintenance_needed = False
        # Host shadows aligned with `ids` (host-ingested corpora only).
        self._host_codes: np.ndarray | None = None
        self._host_scales: np.ndarray | None = None
        self._host_resid: np.ndarray | None = None
        self._host_resid_scales: np.ndarray | None = None
        self._base_dirty = False
        self._ckpt_path: str | None = None

    @property
    def count(self) -> int:
        return len(self._live)

    @property
    def M(self) -> int:
        return self.data[self.own[0]].shape[1]

    def _pin_mean(self, vectors: np.ndarray | None) -> None:
        """Pin the shared quantization center (idempotent), before the first
        code lands in the table or the spill."""
        if self.mean is not None:
            return
        if self.center and vectors is not None and len(vectors):
            mean = np.asarray(vectors, np.float32).mean(axis=0)
            self.mean = from_rank0(torch.from_numpy(mean), self.group).numpy()
        else:
            self.mean = np.zeros((self.dim,), np.float32)
        if self.spill.count and self.mean.any():
            raise RuntimeError("spill holds raw codes; cannot center after the fact")

    def _centered(self, vectors: np.ndarray) -> np.ndarray:
        if self.mean is not None and self.mean.any():
            return vectors - self.mean
        return vectors

    def _set_centroids(self, centroids: torch.Tensor) -> None:
        self.centroids = centroids.to(self.lead)
        self._cent = replicate(self.centroids, self.devices)

    def _sizes_host(self) -> np.ndarray:
        return self._sizes_h

    def _set_sizes(self, sizes: np.ndarray) -> None:
        self._sizes_h = np.asarray(sizes, np.int64)
        self.sizes = row_blocks(torch.from_numpy(self._sizes_h.astype(np.int32)), self.devices)

    def _drop_table(self) -> None:
        self.data = self.rscales = self.sizes = self.resid = self.resid_scales = None
        self._rowids_dev = None
        self._sizes_h = None
        self.rowids = None

    def _bucket_rows(self, counts: np.ndarray, at_least: int = 0) -> int:
        M = max(int(max(8, self.bucket_factor * max(1, counts.mean()))), at_least)
        return -(-M // 1024) * 1024  # the batch scan runs S = 1024 chunks

    # -- placement across shards ----------------------------------------------

    def _new_tables(self, M: int, tail: tuple, dtype: torch.dtype, fill) -> list:
        """One [Cp, M, *tail] table per own shard, on its device, set to
        fill (None for another rank's)."""
        return [None if d is None else torch.full((self.Cp, M, *tail), fill, dtype=dtype, device=d)
                for d in self.devices]

    def _scatter_into(self, tables: list[list[torch.Tensor]], dest: torch.Tensor,
                      srcs: list[torch.Tensor]) -> None:
        """Row i of every srcs[j] lands at global flat slot dest[i] of
        tables[j] (per-shard [Cp, M, ...]); a dest past the last slot
        drops. Blocks of rows at a time, each copied to its shard (own
        shards only: another rank writes its own)."""
        span = self.Cp * tables[0][self.own[0]].shape[1]
        flats = [_flat(t) for t in tables]
        for lo in range(0, dest.shape[0], _BLOCK):
            d = dest[lo : lo + _BLOCK]
            shard = d // span
            for p, dev in enumerate(self.devices):
                if dev is None:
                    continue
                ok = torch.nonzero(shard == p).squeeze(1)
                if not ok.numel():
                    continue
                tgt = (d[ok] - p * span).to(dev)
                for flat, src in zip(flats, srcs):
                    flat[p][tgt] = src[lo : lo + _BLOCK][ok.to(src.device)].to(dev)

    def _gather(self, tables: list, sel: np.ndarray) -> torch.Tensor:
        """Global flat slots `sel` of a per-shard table, in sel's order, on
        the lead device (under a process group: every rank's own slots,
        summed into one zeroed buffer)."""
        flats = _flat(tables)
        first = flats[self.own[0]]
        span = first.shape[0]
        out = torch.zeros((len(sel), *first.shape[1:]), dtype=first.dtype, device=self.lead)
        shard = sel // span
        for p in np.unique(shard):
            if flats[p] is None:
                continue
            pos = np.nonzero(shard == p)[0]
            local = torch.from_numpy(sel[pos] - p * span).to(self.devices[p])
            out[torch.from_numpy(pos).to(self.lead)] = flats[p][local].to(self.lead)
        return sum_across(out, self.group)

    def _pack(self, vecs_q, scales, assign: torch.Tensor, counts: torch.Tensor, M: int,
              resid=None, resid_scales=None):
        """Bucket tables from rows and their cluster assignment (padding
        rows assigned C): rows stable-packed cluster by cluster, the rowid
        of a slot the row's index. Returns the cluster sort `order`."""
        dest, order = bucket_pack_dest(assign, counts, self.C, M)
        rid = torch.arange(vecs_q.shape[0], dtype=torch.int32, device=vecs_q.device)
        D = self.dim
        self.data = self._new_tables(M, (D,), torch.int8, 0)
        self.rscales = self._new_tables(M, (), torch.float32, 0.0)
        self._rowids_dev = self._new_tables(M, (), torch.int32, -1)
        self._scatter_into([self.data, self.rscales, self._rowids_dev], dest,
                           [vecs_q, scales, rid])
        if self.refine:
            if resid is None:
                # No residual source (a device-only corpus or a pre-refine
                # checkpoint): a zero residual table, the plain int8 rescore.
                logger.info("sharded ivf: refine on but no residual source; zero residuals")
                resid = torch.zeros_like(vecs_q)
                resid_scales = torch.zeros_like(scales)
            self.resid = self._new_tables(M, (D,), torch.int8, 0)
            self.resid_scales = self._new_tables(M, (), torch.float32, 0.0)
            self._scatter_into([self.resid, self.resid_scales], dest, [resid, resid_scales])
        else:
            self.resid = self.resid_scales = None
        self._set_sizes(np.minimum(counts.cpu().numpy(), M))
        self.rowids = None
        return order

    def _assign(self, vecs_q, scales) -> torch.Tensor:
        """Nearest centroid of each int8 row (bf16 rows times bf16 scales);
        rank 0's under a process group."""
        n, dev = vecs_q.shape[0], vecs_q.device
        if not n:
            return torch.zeros((0,), dtype=torch.int64, device=dev)
        if not self.rank0:
            return from_rank0(torch.empty((n,), dtype=torch.int64, device=dev), self.group)
        parts = [kmeans_assign(vecs_q[s : s + _BLOCK].to(torch.bfloat16)
                               * scales[s : s + _BLOCK, None].to(torch.bfloat16),
                               self.centroids.to(dev))
                 for s in range(0, n, _BLOCK)]
        return from_rank0(torch.cat(parts), self.group)

    # -- build ----------------------------------------------------------------

    def build(self, vectors: np.ndarray, ids: list) -> None:
        """Host-corpus build: quantize on the host (native_lib, as memex_tpu
        does), keep the codes as the checkpoint shadow, ship them to the
        lead device and run the device build."""
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        if n != len(ids):
            raise ValueError(f"{n} vectors for {len(ids)} ids")
        self._pin_mean(vectors)
        vectors = self._centered(vectors)
        if n < self.C * 4:
            logger.info("sharded ivf build: n=%d too small for C=%d, spill only", n, self.C)
            self.spill.add(vectors, ids)
            self._live.update(ids)
            return
        vectors = np.ascontiguousarray(vectors, np.float32)
        rq = rs = None
        if self.refine:
            from ..native_lib import np_quantize_rows_int8_refine

            q, s, rq, rs = np_quantize_rows_int8_refine(vectors)
        else:
            from ..native_lib import np_quantize_rows_int8

            q, s = np_quantize_rows_int8(vectors)

        def dev(a):
            return None if a is None else torch.from_numpy(a).to(self.lead)

        self.build_device(dev(q), dev(s), list(ids), resid=dev(rq), resid_scales=dev(rs))
        # build_device dropped the shadows (device-only path); these rows
        # came through the host.
        self._host_codes, self._host_scales = q, s
        self._host_resid, self._host_resid_scales = rq, rs

    def build_device(self, vecs_q: torch.Tensor, scales: torch.Tensor, ids: list,
                     n_valid: int | None = None, resid=None, resid_scales=None) -> None:
        """Build from an int8 corpus on a device (vecs_q [N, D] int8, scales
        [N] f32; rows at index >= n_valid are padding and never land):
        k-means on a dequantized sample, blockwise assignment, the stable
        cluster sort, and the scatter of each cluster's rows to its shard.
        Only counts come to the host. Bucket overflow goes to the spill
        and is folded into the next-nearest clusters with free slots."""
        n, d = vecs_q.shape
        if n_valid is None:
            n_valid = n
        if d != self.dim or n != len(ids):
            raise ValueError(f"codes {tuple(vecs_q.shape)} do not match {len(ids)} ids x "
                             f"dim {self.dim}")
        if n_valid < self.C * 4:
            raise ValueError(f"n={n_valid} too small for C={self.C}")
        if self.mean is None:
            self._pin_mean(None)  # caller-quantized raw codes: zero mean
        self._live.update(i for i in ids[:n_valid] if i is not None)
        self._host_codes = self._host_scales = None
        self._host_resid = self._host_resid_scales = None

        dev = vecs_q.device
        if self.rank0:
            m_samp = min(n_valid, max(self.C * 64, 65536))
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            samp_idx = _train_sample(n_valid, m_samp, gen)
            sample = vecs_q[samp_idx].float() * scales[samp_idx, None]
            cent = kmeans_fit(sample, self.C, seed=self.seed, generator=gen)
            del sample
        else:  # rank 0 fits the k-means; the others receive its centroids
            cent = torch.empty((self.C, d), dtype=torch.float32, device=dev)
        self._set_centroids(from_rank0(cent, self.group))

        assign = self._assign(vecs_q, scales)
        if n_valid < n:
            assign = torch.where(torch.arange(n, device=dev) < n_valid, assign, self.C)
        counts = torch.bincount(assign, minlength=self.C + 1)[: self.C]
        counts_h = counts.cpu().numpy()
        M = self._bucket_rows(counts_h)
        order = self._pack(vecs_q, scales, assign, counts, M, resid, resid_scales)
        self.ids = list(ids)
        self._ids_nulled = False
        self._base_dirty = True

        # Overflow: cluster c's rows past M sit at sorted positions
        # starts[c] + M .. starts[c] + counts[c].
        starts = np.concatenate([[0], np.cumsum(counts_h)[:-1]])
        over = np.nonzero(counts_h > M)[0]
        if len(over):
            sel = np.concatenate([np.arange(starts[c] + M, starts[c] + counts_h[c])
                                  for c in over])
            spill_rows = order[torch.from_numpy(sel).to(dev)].cpu().numpy()
            sids = np.asarray(ids, dtype=object)[spill_rows]
            live = np.asarray([s is not None for s in sids], bool)
            if live.any():
                rows = torch.from_numpy(spill_rows[live]).to(dev)
                codes = vecs_q[rows].cpu().numpy()
                vecs = codes.astype(np.float32) * scales[rows].cpu().numpy()[:, None]
                logger.info("sharded ivf build: %d overflow rows -> spill", len(vecs))
                self.spill.add(vecs, sids[live].tolist())
                folded = self.fold_spill()
                logger.info("sharded ivf build: folded %d/%d overflow rows into alternate "
                            "buckets (%d remain spilled)", folded, len(vecs), self.spill.count)

    def _rowids_host(self) -> np.ndarray | None:
        """[C, M] row ids on the host (under a process group every rank's
        own blocks, all_gathered in shard order)."""
        if self.rowids is None and self._rowids_dev is not None:
            own = torch.cat([self._rowids_dev[p].to(self.lead) for p in self.own])
            if self.group is not None:
                own = all_gather_cat(own, self.group, dim=0)
            self.rowids = own.cpu().numpy().astype(np.int64)
        return self.rowids

    def _table_rows(self, cl: np.ndarray, sl: np.ndarray) -> np.ndarray:
        """Dequantized table rows at (cluster, slot), float32 on the host
        (under a process group every rank's own, summed)."""
        out = np.zeros((len(cl), self.dim), np.float32)
        M, shard = self.M, cl // self.Cp
        for p in np.unique(shard):
            if self.devices[p] is None:
                continue
            pos = np.nonzero(shard == p)[0]
            flat = torch.from_numpy((cl[pos] - p * self.Cp) * M + sl[pos]).to(self.devices[p])
            rows = _flat(self.data)[p][flat].float() * _flat(self.rscales)[p][flat][:, None]
            out[pos] = rows.cpu().numpy()
        return sum_across(torch.from_numpy(out), self.group).numpy()

    # -- mutation -------------------------------------------------------------

    def add(self, vectors: np.ndarray, ids: list) -> None:
        """Streaming ingest into the spill; rebuild() folds it in. Re-adding
        a deleted id un-deletes it (its stale table copy has its id nulled);
        ids already live are no-ops."""
        vectors = np.asarray(vectors, np.float32)
        self._pin_mean(vectors)
        vectors = self._centered(vectors)
        readd = self._deleted.intersection(ids)
        if readd:
            for i, sid in enumerate(self.ids):
                if sid in readd:
                    self.ids[i] = None
                    self._ids_nulled = True
            self._deleted -= readd
            self._base_dirty = True
        if any(sid in self._live for sid in ids):
            fresh = [i for i, sid in enumerate(ids) if sid not in self._live]
            if not fresh:
                return
            vectors = vectors[fresh]
            ids = [ids[i] for i in fresh]
        self.spill.add(vectors, ids)
        self._live.update(ids)

    def delete(self, ids: list) -> int:
        if isinstance(ids, str):
            ids = [ids]  # a bare string would iterate characters
        removed = 0
        for sid in ids:
            if sid in self._live:
                self._deleted.add(sid)
                self._live.discard(sid)
                removed += 1
        self.spill.delete(list(ids))
        return removed

    def delete_all(self) -> None:
        self.centroids = None
        self._cent = []
        self._drop_table()
        self.mean = None  # re-pinned at the next ingest
        self.ids = []
        self._ids_nulled = False
        self._deleted.clear()
        self._live.clear()
        self.spill.delete_all()
        self._host_codes = self._host_scales = None
        self._host_resid = self._host_resid_scales = None
        self._base_dirty = True

    def fold_spill(self) -> int:
        """Stream spill rows into the existing cluster shards in place: each
        row goes to the nearest cluster with a free slot among its top
        FOLD_CHOICES (current centroids, no retrain); rows that fit nowhere
        stay in the spill. Returns rows folded."""
        if self.data is None or self.centroids is None or not self.spill.count:
            return 0
        C, M, D = self.C, self.M, self.dim
        rows = sorted(self.spill.ids.items())
        if self._deleted:
            rows = [(g, s) for g, s in rows if s not in self._deleted]
        if not rows:
            self.spill.delete_all()
            return 0
        ssel = np.asarray([g for g, _ in rows])
        sids_sel = np.asarray([s for _, s in rows], dtype=object)
        n = len(ssel)
        # The spill's rows from its host shadow (int8 codes, written through
        # on every add): the same bytes its devices hold.
        codes = torch.from_numpy(self.spill._sh_rows[ssel]).to(self.lead)
        scales = torch.from_numpy(self.spill._sh_scales[ssel]).to(self.lead)
        R = min(IVFIndex.FOLD_CHOICES, C)
        choice = (_topk_clusters(codes, scales, self.centroids, n, R) if self.rank0
                  else np.empty((n, R), np.int32))
        choice = from_rank0(torch.from_numpy(choice), self.group).numpy()
        a_final, slot_final, sizes_fill = _capacity_fill(choice, self._sizes_h, M)
        ok = a_final >= 0
        n_fold = int(ok.sum())
        if n_fold == 0:
            return 0
        dest = np.full((n,), C * M, np.int64)
        dest[ok] = a_final[ok] * M + slot_final[ok]
        base = len(self.ids)
        rid_new = torch.from_numpy(base + np.arange(n, dtype=np.int32)).to(self.lead)
        self._scatter_into([self.data, self.rscales, self._rowids_dev],
                           torch.from_numpy(dest).to(self.lead), [codes, scales, rid_new])
        self.rowids = None
        self._set_sizes(sizes_fill)
        new_ids = np.full((n,), None, dtype=object)
        new_ids[ok] = sids_sel[ok]
        # Extend the ids-aligned host shadow from the spill's (folded rows
        # carry no residuals: zero-extend that shadow).
        if self._host_codes is not None and len(self._host_codes) == base:
            self._host_codes = np.concatenate([self._host_codes, self.spill._sh_rows[ssel]])
            self._host_scales = np.concatenate([self._host_scales,
                                                self.spill._sh_scales[ssel]])
            if self._host_resid is not None:
                self._host_resid = np.concatenate(
                    [self._host_resid, np.zeros((n, D), np.int8)])
                self._host_resid_scales = np.concatenate(
                    [self._host_resid_scales, np.zeros((n,), np.float32)])
        else:
            self._host_codes = self._host_scales = None
            self._host_resid = self._host_resid_scales = None
        self.ids.extend(new_ids.tolist())
        # Leftovers re-enter a fresh spill from the host shadow.
        left_ids = sids_sel[~ok].tolist()
        left_rows = self.spill.rows_f32(ssel[~ok].tolist()) if left_ids else None
        self.spill.delete_all()
        if left_ids:
            self.spill.add(left_rows, left_ids)
        self._base_dirty = True
        return n_fold

    def rebuild(self) -> None:
        """Fold the spill in and drop tombstones, retraining: the live table
        rows (gathered from the shards) and the live spill rows form one
        compacted corpus on the lead device, the table is freed, and
        build_device() runs on it."""
        if len(self._live) < self.C * 4:
            return  # spill-only regime; nothing to fold
        codes_l, scales_l, resid_l, rscales_l, ids_all = [], [], [], [], []
        if self.data is not None:
            rowids = self._rowids_host()
            M = rowids.shape[1]
            valid = (np.arange(M)[None, :] < self._sizes_h[:, None]) & (rowids >= 0)
            ids_arr = np.asarray(self.ids, dtype=object)
            if self._deleted or self._ids_nulled:
                sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                if self._ids_nulled:
                    valid &= np.not_equal(sids, None)
                if self._deleted:
                    valid &= ~np.isin(sids.astype(str), sorted(self._deleted))
            sel = np.nonzero(valid.reshape(-1))[0]
            ids_all.extend(ids_arr[rowids[valid]].tolist())
            codes_l.append(self._gather(self.data, sel))
            scales_l.append(self._gather(self.rscales, sel))
            if self.refine and self.resid is not None:
                # Residuals follow their rows (spill rows get zeros).
                resid_l.append(self._gather(self.resid, sel))
                rscales_l.append(self._gather(self.resid_scales, sel))
            self._drop_table()  # before the build allocates the next one
        if self.spill.count:
            rows = sorted(self.spill.ids.items())
            sel = np.asarray([g for g, _ in rows])
            ids_all.extend(s for _, s in rows)
            codes_l.append(torch.from_numpy(self.spill._sh_rows[sel]).to(self.lead))
            scales_l.append(torch.from_numpy(self.spill._sh_scales[sel]).to(self.lead))
            if resid_l:
                resid_l.append(torch.zeros_like(codes_l[-1]))
                rscales_l.append(torch.zeros_like(scales_l[-1]))
        codes, scales = torch.cat(codes_l), torch.cat(scales_l)
        resid = torch.cat(resid_l) if resid_l else None
        resid_scales = torch.cat(rscales_l) if rscales_l else None
        del codes_l, scales_l, resid_l, rscales_l
        self.spill.delete_all()
        self._deleted.clear()
        self._live.clear()
        self.ids = []
        self.build_device(codes, scales, ids_all, resid=resid, resid_scales=resid_scales)

    # -- search ---------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        out = self._search_once(queries, k)
        # The over-fetch is capped at 512, so deletes concentrated in one
        # topic can crowd out every live candidate: one exact pass widened
        # past the dead count (no retrain), and maintenance is flagged for
        # the store to schedule the rebuild on the worker.
        if self._deleted:
            expect = min(k, self.count)
            if any(len(r) < expect for r in out):
                logger.warning("sharded ivf shortfall under %d tombstones; exact fallback "
                               "(maintenance flagged)", len(self._deleted))
                out = self._search_exact(queries, k)
                self.maintenance_needed = True
        return out

    def _check_batch_shape(self, M: int, kk: int, banks: int) -> None:
        S = banks * 128
        if kk > S or M % S or M // S > 256:
            raise ValueError(
                f"sharded IVF shard shape [Cp={self.Cp}, M={M}, D={self.dim}] with kk={kk} "
                f"is outside the batch kernel's range (kk <= S = {S}, M % S == 0, "
                f"M // S <= 256)")

    def _shard_candidates(self, p: int, q: torch.Tensor, kk: int, use_refine: bool):
        """Shard p's top-kk: (vals, rowid) [Q, kk] on its device. Launches
        only: no host sync."""
        data, rsc, sizes = self.data[p], self.rscales[p], self.sizes[p]
        M = data.shape[1]
        mask = _shard_mask(self._cent[p], q, self.nprobe, self.prune_margin,
                           p * self.Cp, self.Cp)
        if self.use_fused:
            banks = 8 if M % 1024 == 0 else 4
            self._check_batch_shape(M, kk, banks)
            ids = torch.arange(self.Cp, device=q.device)
            order = torch.argsort(torch.where(mask, ids, self.Cp + ids)).to(torch.int32)
            nact = mask.sum(dtype=torch.int32).reshape(1)
            vals, cl, sl = ivf_batch_topk(data, rsc, sizes, order, nact, q, kk, banks=banks)
            cl, sl = cl.long(), sl.long()
        else:
            vals, flat_idx = _dense_topk(data, rsc, sizes, q, kk, mask)
            cl, sl = flat_idx // M, flat_idx % M
        if use_refine:
            # Rescore the shard's own candidates from coarse + residual
            # codes in true float32; sentinel lanes keep their sentinel.
            rows = data[cl, sl].float() * rsc[cl, sl][..., None]
            rows = rows + (self.resid[p][cl, sl].float()
                           * self.resid_scales[p][cl, sl][..., None])
            scores = scores_f32(q[:, None, :], rows.transpose(1, 2), exact=True)[:, 0]
            vals = torch.where(vals > -1e29, scores, vals)
        return vals, self._rowids_dev[p][cl, sl]

    def _table_hits(self, vals: torch.Tensor, orig: torch.Tensor, merged: list[dict]) -> None:
        vals, orig = vals.cpu().numpy(), orig.cpu().numpy()
        for qi in range(len(merged)):
            for v, r in zip(vals[qi], orig[qi]):
                if v <= -1e29 or r < 0:
                    continue
                sid = self.ids[r]
                if sid is None or sid in self._deleted:
                    continue
                merged[qi][sid] = float(v)

    def _search_once(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        merged: list[dict] = [dict() for _ in range(queries.shape[0])]
        # Centered codes (table and spill): true cosines come back with the
        # query-constant q . mean after the merge.
        off = queries @ self.mean if self.mean is not None and self.mean.any() else None
        if self.data is not None:
            total = int(self._sizes_h.sum())
            kk = min(k + len(self._deleted), total, 512)
            if self.rerank:
                # The refined scores ride the kk-wide merge.
                kk = min(max(kk, self.rerank), total, 512)
            if kk > 0:
                use_refine = self.refine and self.resid is not None
                q = replicate(torch.from_numpy(queries), [self.devices[p] for p in self.own])
                vals, orig = zip(*(self._shard_candidates(p, q[j], kk, use_refine)
                                   for j, p in enumerate(self.own)))
                self._table_hits(*merge_topk_across(list(vals), list(orig), kk, self.lead,
                                                    self.group), merged)
        if self.spill.count:
            for qi, hits in enumerate(self.spill.search(queries, min(k, self.spill.count))):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        return _top_with_offset(merged, off, k)

    def _search_exact(self, queries: np.ndarray, k: int) -> list[list[tuple]]:
        """Exact pass over table and spill with the over-fetch widened past
        every tombstone (kk rounded up to a power of two): right under any
        delete pattern, no retrain."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        merged: list[dict] = [dict() for _ in range(queries.shape[0])]
        off = queries @ self.mean if self.mean is not None and self.mean.any() else None
        if self.data is not None:
            total = int(self._sizes_h.sum())
            kk = min(k + len(self._deleted), total)
            if kk > 0:
                kk = min(1 << (kk - 1).bit_length(), total)
                q = replicate(torch.from_numpy(queries), [self.devices[p] for p in self.own])
                vals, orig = [], []
                for j, p in enumerate(self.own):
                    v, fidx = _dense_topk(self.data[p], self.rscales[p], self.sizes[p], q[j], kk)
                    vals.append(v)
                    orig.append(_flat(self._rowids_dev)[p][fidx])
                self._table_hits(*merge_topk_across(vals, orig, kk, self.lead, self.group),
                                 merged)
        if self.spill.count:
            ksp = min(k + len(self._deleted), self.spill.count)
            for qi, hits in enumerate(self.spill.search(queries, ksp)):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        return _top_with_offset(merged, off, k)

    def calibrate_margin(self, queries: np.ndarray | None = None, k: int = 10,
                         target_overlap: float = 0.97, margins=None, n_queries: int = 64,
                         seed: int = 0, target_metric: str = "overlap") -> float | None:
        """Auto-tune prune_margin to a recall target; see ivf.calibrate_prune_margin."""
        return calibrate_prune_margin(self, queries=queries, k=k, target_overlap=target_overlap,
                                      margins=margins, n_queries=n_queries, seed=seed,
                                      target_metric=target_metric)

    def calibrate_operating_point(self, queries: np.ndarray | None = None, k: int = 10,
                                  target_recall: float = 0.95, nprobes=None,
                                  n_queries: int = 64, seed: int = 0,
                                  margins=None) -> dict | None:
        """Jointly pick (nprobe, prune_margin); see ivf.calibrate_operating_point."""
        return calibrate_operating_point(self, queries=queries, k=k,
                                         target_recall=target_recall, nprobes=nprobes,
                                         n_queries=n_queries, seed=seed, margins=margins)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """memex_tpu's layout: an immutable base `{path}.npz` (rewritten when
        dirty; from the host shadow when the corpus came through the host,
        else gathered from the shards), `{path}.meta.json`, and the spill's
        own segment log `{path}.spill.*`. Under a process group every rank
        writes its own copy of the same files, as every memex_tpu process
        does; a rewrite gathers from every rank's shards, so only state that
        every rank holds alike decides it (a base file missing on one rank
        alone waits for the next rewrite)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if (self._base_dirty or path != self._ckpt_path
                or (self.group is None and not os.path.exists(path + ".npz"))):
            arrs: dict[str, np.ndarray] = {
                "centroids": (self.centroids.cpu().numpy() if self.centroids is not None
                              else np.zeros((0, self.dim), np.float32)),
            }
            if self.data is not None:
                rowids = self._rowids_host()
                M = rowids.shape[1]
                valid = (np.arange(M)[None, :] < self._sizes_h[:, None]) & (rowids >= 0)
                if self._ids_nulled:
                    ids_arr = np.asarray(self.ids, dtype=object)
                    sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                    valid &= np.not_equal(sids, None)
                rid_sel = rowids[valid]
                sel = np.nonzero(valid.reshape(-1))[0]
                arrs["cluster_assign"] = np.nonzero(valid)[0].astype(np.int32)
                arrs["cluster_ids"] = np.asarray(
                    np.asarray(self.ids, dtype=object)[rid_sel].tolist())
                if self._host_codes is not None:
                    arrs["cluster_codes"] = self._host_codes[rid_sel]
                    arrs["cluster_scales"] = self._host_scales[rid_sel]
                else:
                    arrs["cluster_codes"] = self._gather(self.data, sel).cpu().numpy()
                    arrs["cluster_scales"] = self._gather(self.rscales, sel).cpu().numpy()
                if self.refine:
                    if (self._host_resid is not None
                            and len(self._host_resid) > rid_sel.max(initial=-1)):
                        arrs["cluster_resid"] = self._host_resid[rid_sel]
                        arrs["cluster_resid_scales"] = self._host_resid_scales[rid_sel]
                    elif self.resid is not None:
                        arrs["cluster_resid"] = self._gather(self.resid, sel).cpu().numpy()
                        arrs["cluster_resid_scales"] = self._gather(
                            self.resid_scales, sel).cpu().numpy()
            else:
                arrs["cluster_assign"] = np.zeros((0,), np.int32)
                arrs["cluster_ids"] = np.zeros((0,), np.str_)
                arrs["cluster_codes"] = np.zeros((0, self.dim), np.int8)
                arrs["cluster_scales"] = np.zeros((0,), np.float32)
            write_atomically(path + ".npz", lambda fh: np.savez(fh, **arrs))
            self._base_dirty = False
            self._ckpt_path = path
        meta = {
            "format": 2,
            "kind": "sharded_ivf",
            "dim": self.dim,
            "n_clusters": self.C,
            "nprobe": self.nprobe,
            "bucket_factor": self.bucket_factor,
            "dtype": self.dtype,
            "refine": self.refine,
            "rerank": self.rerank,
            "deleted": sorted(str(s) for s in self._deleted),
        }
        if self.mean is not None:
            meta["mean"] = [float(x) for x in self.mean]
        write_atomically(path + ".meta.json", lambda fh: fh.write(json.dumps(meta).encode()))
        self.spill.save(path + ".spill")

    def restore(self, path: str) -> int:
        """Load a checkpoint into this (fresh) index: the base rows are
        reassigned on the saved centroids (no k-means) and packed into the
        shards; the spill's segments replay through the spill. Returns the
        rows restored. As in memex_tpu, the saved `refine` and `rerank` are
        not read: the constructor's hold."""
        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        deleted = set(meta.get("deleted", []))
        if "mean" in meta:
            # Before any codes land: table and spill rows are centered at it.
            self.mean = np.asarray(meta["mean"], np.float32)
        arrs = np.load(path + ".npz")
        restored = 0
        cids = arrs["cluster_ids"]
        if len(arrs["centroids"]) and len(cids):
            keep = ~np.isin(cids.astype(str), sorted(deleted)) if deleted else slice(None)
            codes = arrs["cluster_codes"][keep]
            scales = arrs["cluster_scales"][keep]
            kept_ids = [str(s) for s in cids[keep]]
            r_codes = r_scales = None
            if self.refine and "cluster_resid" in arrs:
                r_codes = arrs["cluster_resid"][keep]
                r_scales = arrs["cluster_resid_scales"][keep]
            self._set_centroids(torch.from_numpy(np.asarray(arrs["centroids"], np.float32)))
            self._pack_with_centroids(codes, scales, kept_ids, r_codes, r_scales)
            self._host_codes, self._host_scales = codes, scales
            self._host_resid, self._host_resid_scales = r_codes, r_scales
            restored += len(kept_ids)
        if os.path.exists(path + ".spill.meta.json"):
            restored += self.spill.restore(path + ".spill")
            self._live.update(self.spill._id_to_row)
        if restored and self.mean is None:
            # Pre-centering checkpoint: its codes are raw; pin zero so later
            # adds stay in the same code space.
            self.mean = np.zeros((self.dim,), np.float32)
        self._ckpt_path = path
        # Filtered deletes: the file still holds the dead rows, so the next
        # save rewrites a compacted base.
        self._base_dirty = bool(deleted)
        return restored

    def _pack_with_centroids(self, codes: np.ndarray, scales: np.ndarray, ids: list,
                             resid: np.ndarray | None = None,
                             resid_scales: np.ndarray | None = None) -> None:
        """Assign host rows to the current centroids and pack them into the
        shards (the restore path: no k-means)."""
        def dev(a):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(self.lead)

        vecs_q, dscales = dev(codes), dev(np.asarray(scales, np.float32))
        assign = self._assign(vecs_q, dscales)
        counts = torch.bincount(assign, minlength=self.C)
        counts_h = counts.cpu().numpy()
        M = self._bucket_rows(counts_h, at_least=int(counts_h.max(initial=0)))
        self._pack(vecs_q, dscales, assign, counts, M, dev(resid), dev(resid_scales))
        self.ids = list(ids)
        self._ids_nulled = False
        self._live.update(ids)

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        FlatIndex.remove_checkpoint(path + ".spill")
        for suffix in (".npz", ".meta.json"):
            try:
                os.remove(path + suffix)
            except FileNotFoundError:
                pass
