"""IVFIndex: k-means partitioned index, the 10M-100M scale tier (port of
memex_tpu/index/ivf.py).

Queries score the centroid table, pick `nprobe` clusters and scan only
those clusters' rows. Layout on the index's device (static shapes):
  data      [C, M, D]  clusters padded to a bucket of M rows (float32,
                       bfloat16, or int8 codes)
  rscales   [C, M]     row scales (int8; ones for the float tiers)
  sizes     [C] int32  live rows per cluster
  centroids [C, D]     float32 unit centroids
  rowids    [C, M]     bucket slot -> index into `ids` (on the host, or on
                       the device for device-built tables)
Vectors arriving after a build go to a spill FlatIndex (the port's, so its
scans are K1-K4); `fold_spill()` streams them into free bucket slots and
`rebuild()` retrains. Search runs the batch-union scan (K5, or K6 over an
int4 mirror), the per-query probe scan (K7) where K5 cannot take the
bucket, or the plain scan without fused kernels.

Where memex_tpu relies on immutable arrays and donated buffers, the port
updates its tensors in place. The checkpoint format is memex_tpu's, so
either package loads the other's checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..log import get_logger

from ..ops.fused_topk import scores_f32
from ..ops.ivf_batch import ivf_batch_search
from ..ops.ivf_batch4 import ivf_batch_search4, pack_int4_buckets
from ..ops.ivf_scan import ivf_probe_topk
from ..ops.topk import blockwise_topk, exact_topk
from .flat import FlatIndex

logger = get_logger(__name__)

# Rows per block of the device-side assignment and packing passes (bounds
# their [block, C] float32 scores and gathered copies).
_BLOCK = 1 << 18


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------


def kmeans_fit(vectors: torch.Tensor, n_clusters: int, iters: int = 10, seed: int = 0, *,
               generator: torch.Generator | None = None, init: torch.Tensor | None = None):
    """Spherical k-means on unit vectors: assign by max inner product
    (bf16 inputs, float32 accumulate), update = renormalized mean; empty
    clusters keep their centroid. Returns [C, D] float32 unit centroids.

    The initial centroids are `init` (row indices into `vectors`, or the
    centroids themselves), else n_clusters rows drawn without replacement
    (with, when there are fewer rows) by `generator`, else by a generator
    seeded with `seed`. torch's draws are not jax.random's: pass memex_tpu's
    indices as `init` to reproduce its fit."""
    n, d = vectors.shape
    dev = vectors.device
    if init is None:
        gen = generator or torch.Generator(device=dev).manual_seed(seed)
        if n >= n_clusters:
            init = torch.randperm(n, generator=gen, device=dev)[:n_clusters]
        else:
            init = torch.randint(n, (n_clusters,), generator=gen, device=dev)
    init = init.to(dev)
    if init.dtype.is_floating_point:
        centroids = init.float()
    else:
        centroids = vectors[init.long()].float()
    v16 = vectors.to(torch.bfloat16).float()
    for _ in range(iters):
        assign = kmeans_assign(vectors, centroids)
        sums = cluster_sums(v16, assign, n_clusters)
        counts = torch.bincount(assign, minlength=n_clusters).float()[:, None]
        means = sums / torch.clamp(counts, min=1.0)
        means = torch.where(counts > 0, means, centroids)
        centroids = means / torch.clamp(means.norm(dim=1, keepdim=True), min=1e-12)
    return centroids


def cluster_sums(rows: torch.Tensor, assign: torch.Tensor, n_clusters: int,
                 block: int | None = None) -> torch.Tensor:
    """[C, D] float32 sums of the rows of each cluster, a fixed function of
    its inputs: blocks of rows in turn, each block as a one-hot product
    [C, block] @ [block, D] in true float32. (`index_add_` sums with float
    atomics on the card, in an order that changes from run to run, and the
    fit would no longer be a function of its seed, as memex_tpu's is.)"""
    n, d = rows.shape
    sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=rows.device)
    ids = torch.arange(n_clusters, device=rows.device)[:, None]
    if block is None:
        block = max(1024, (1 << 26) // n_clusters)  # a one-hot block of <= 256 MB
    for lo in range(0, n, block):
        onehot = (assign[None, lo : lo + block] == ids).float()
        sums += scores_f32(onehot, rows[lo : lo + block].float(), exact=True)
    return sums


def kmeans_assign(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row by bf16-input, float32-accumulated inner
    product; ties by the lower cluster."""
    return scores_f32(vectors, centroids.T, exact=False).argmax(dim=1)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _route(centroids: torch.Tensor, queries: torch.Tensor, nprobe: int) -> torch.Tensor:
    """Each query's nprobe best clusters by true float32 score, in order
    (bf16 would misroute probes on near-tied centroid scores)."""
    return exact_topk(scores_f32(queries, centroids.T, exact=True), nprobe)[1].long()


def _ivf_search(centroids, data, rscales, sizes, queries, nprobe: int, k: int):
    """Plain per-query IVF: (vals [Q, k], cluster [Q, k], slot [Q, k]).
    Each probe step gathers one cluster per query; all probe scores are
    kept and one exact top-k taken. float32 rows score in true float32;
    the other tiers from bf16 inputs times the row scale."""
    Q = queries.shape[0]
    M = data.shape[1]
    probes = _route(centroids, queries, nprobe)
    exact = data.dtype == torch.float32
    col = torch.arange(M, device=data.device)[None, :]
    parts = []
    for p in range(nprobe):
        cids = probes[:, p]
        sc = scores_f32(queries[:, None, :], data[cids].transpose(1, 2), exact)[:, 0]
        if not exact:
            sc = sc * rscales[cids]
        parts.append(torch.where(col < sizes.long()[cids][:, None], sc, -1e30))
    vals, flat_idx = blockwise_topk(torch.cat(parts, dim=1).reshape(Q, nprobe * M), k)
    flat_idx = flat_idx.long()
    return vals, torch.gather(probes, 1, flat_idx // M), flat_idx % M


def _ivf_search_fused(centroids, data, rscales, sizes, queries, nprobe: int, k: int,
                      banks: int = 2):
    """Routing + the per-query probe scan (K7)."""
    return ivf_probe_topk(data, rscales, sizes, _route(centroids, queries, nprobe), queries,
                          k, banks=banks)


def _topk_clusters(codes, scales, centroids, n: int, R: int, blk: int = _BLOCK, mean=None):
    """Top-R candidate clusters per quantized row, [n, R] int32 on the host.
    memex_tpu scores bf16 rows against bf16 centroids into a bf16 result
    (and adds the bf16 mean correction in bf16); ties by the lower cluster.

    `mean`: when codes are mean-centered residuals, row-to-cluster scores
    need + mean . centroids (a [C] vector that varies across clusters)."""
    cent = centroids.to(torch.bfloat16).float()
    moff = None
    if mean is not None and np.asarray(mean).any():
        m16 = torch.from_numpy(np.asarray(mean, np.float32)).to(cent.device).to(torch.bfloat16)
        moff = scores_f32(m16.float()[None, :], cent.T, exact=True).to(torch.bfloat16)
    tops = []
    for s in range(0, codes.shape[0], blk):
        x = codes[s : s + blk].to(torch.bfloat16) * scales[s : s + blk, None].to(torch.bfloat16)
        sc = scores_f32(x.float(), cent.T, exact=True).to(torch.bfloat16)
        if moff is not None:
            sc = sc + moff
        tops.append(torch.sort(sc.float(), dim=1, descending=True, stable=True)
                    .indices[:, :R].to(torch.int32))
    return torch.cat(tops)[:n].cpu().numpy()


def _exact_topk_rerank(data, rscales, queries, vals, cl, sl, keep: int, resid=None,
                       resid_scales=None):
    """Exact re-scoring of the coarse scan's candidates: gather the stored
    rows (dequantized; with the refinement store, coarse + residual codes)
    and redo the dot in true float32. Sentinel candidates (vals <= -1e29)
    keep their sentinel. Returns (vals, cl, sl) [Q, keep]."""
    c, s = cl.long(), sl.long()
    rows = data[c, s].float() * rscales[c, s][..., None]
    if resid is not None:
        rows = rows + resid[c, s].float() * resid_scales[c, s][..., None]
    scores = scores_f32(queries[:, None, :], rows.transpose(1, 2), exact=True)[:, 0]
    scores = torch.where(vals > -1e29, scores, vals)
    top_v, top_j = exact_topk(scores, keep)
    top_j = top_j.long()
    return top_v, torch.gather(cl, 1, top_j), torch.gather(sl, 1, top_j)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def _capacity_fill(choice: np.ndarray, sizes: np.ndarray, M: int):
    """Greedy capacity-aware placement: round j sends each still-homeless
    row to its j-th-nearest cluster if that bucket has free slots. Rows
    whose nearest bucket has space land exactly where plain assignment
    would put them (round 0). Returns (cluster [n] with -1 for unplaced,
    slot [n], sizes_after [C])."""
    n, R = choice.shape
    C = len(sizes)
    sizes_fill = sizes.astype(np.int64).copy()
    a_final = np.full((n,), -1, np.int64)
    slot_final = np.full((n,), -1, np.int64)
    for j in range(R):
        rem = np.nonzero(a_final < 0)[0]
        if not len(rem):
            break
        cand = choice[rem, j].astype(np.int64)
        ordj = np.argsort(cand, kind="stable")
        cnt = np.bincount(cand[ordj], minlength=C)
        startsj = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        posj = np.arange(len(cand), dtype=np.int64) - startsj[cand[ordj]]
        slotj = sizes_fill[cand[ordj]] + posj
        okj = slotj < M
        rows = rem[ordj[okj]]
        a_final[rows] = cand[ordj[okj]]
        slot_final[rows] = slotj[okj]
        sizes_fill = np.minimum(sizes_fill + np.bincount(cand[ordj[okj]], minlength=C), M)
    return a_final, slot_final, sizes_fill


def bucket_pack_dest(assign: torch.Tensor, counts: torch.Tensor, C: int, M: int):
    """Per-row scatter destination into the padded [C * M] bucket layout:
    rows stable-packed cluster-sorted; rows past a full bucket, and padding
    rows routed to pseudo-cluster C, get dest == C * M (out of bounds: the
    scatters drop them; they go to the spill). Returns (dest, order), order
    the stable cluster sort (cluster c's overflow sits at sorted positions
    starts[c] + M .. counts[c])."""
    n = assign.shape[0]
    dev = assign.device
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order].long()
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        torch.cumsum(counts.long(), 0)])  # [C + 1]: pseudo-cluster C too
    pos = torch.arange(n, device=dev) - starts[sorted_assign]
    dest_sorted = torch.where((pos < M) & (sorted_assign < C), sorted_assign * M + pos, C * M)
    dest = torch.empty((n,), dtype=torch.int64, device=dev)
    dest[order] = dest_sorted
    return dest, order


def _in_bounds(dest: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nonzero(dest < n).squeeze(1)


def pack_scatter_int8(vecs_q, scales, dest, C: int, M: int):
    """int8 rows and scales scattered into fresh [C, M] buckets, with the
    rowid table (row index into the input, -1 where empty); out-of-bounds
    dests drop. Scattered a block at a time into the one output buffer."""
    n, D = vecs_q.shape
    dev = vecs_q.device
    data = torch.zeros((C * M, D), dtype=torch.int8, device=dev)
    rsc = torch.zeros((C * M,), dtype=torch.float32, device=dev)
    rid = torch.full((C * M,), -1, dtype=torch.int32, device=dev)
    for lo in range(0, n, _BLOCK):
        d = dest[lo : lo + _BLOCK]
        ok = _in_bounds(d, C * M)
        tgt = d[ok]
        data[tgt] = vecs_q[lo : lo + _BLOCK][ok]
        rsc[tgt] = scales[lo : lo + _BLOCK][ok]
        rid[tgt] = (ok + lo).to(torch.int32)
    return data.view(C, M, D), rsc.view(C, M), rid.view(C, M)


def _land_rows(codes, scales, part_c, part_s, idx) -> None:
    """Land a (small) row block into the compacted corpus buffers, in place;
    out-of-bounds idx (padding) drops."""
    ok = _in_bounds(idx, codes.shape[0])
    codes[idx[ok]] = part_c[ok]
    scales[idx[ok]] = part_s[ok]


def _fold_scatter(data, rsc, rid, codes, scales, dest, rid_new) -> None:
    """In-place scatter of spill rows into bucket slots (the fold_spill hot
    op); out-of-bounds dests (full buckets) drop."""
    C, M, D = data.shape
    ok = _in_bounds(dest, C * M)
    tgt = dest[ok]
    data.view(C * M, D)[tgt] = codes[ok]
    rsc.view(C * M)[tgt] = scales[ok]
    rid.view(C * M)[tgt] = rid_new[ok].to(torch.int32)


def _fold_scatter_resid(resid, rsc2, rcodes, rscales, dest) -> None:
    """Refinement-table twin of _fold_scatter: residual codes follow their
    coarse codes slot for slot."""
    C, M, D = resid.shape
    ok = _in_bounds(dest, C * M)
    resid.view(C * M, D)[dest[ok]] = rcodes[ok]
    rsc2.view(C * M)[dest[ok]] = rscales[ok]


def _take(src: torch.Tensor, sel: np.ndarray) -> torch.Tensor:
    return src[torch.from_numpy(np.asarray(sel, np.int64)).to(src.device)]


class IVFIndex:
    """k-means inverted-file index on `device`.

    build(vectors, ids) trains centroids and packs clusters; add() streams
    into a flat spill index; fold_spill() / rebuild() fold the spill in."""

    # How many nearest clusters a spill row may fold into (the first is its
    # true assignment; a full bucket sends it to the nearest with space).
    FOLD_CHOICES = 8

    def __init__(self, dim: int, n_clusters: int = 256, nprobe: int = 32,
                 bucket_factor: float = 2.0, seed: int = 0, dtype: str = "float32",
                 use_fused: bool | None = None, scan_int4: bool = False,
                 prune_margin: float | None = None, center: bool | None = None,
                 rerank: int | None = None, scan_precision: str = "default",
                 refine: bool = False, *, device: torch.device | str):
        """dtype "float32", "bfloat16" or "int8". scan_int4 (int8 only)
        scans a packed int4 mirror and reranks against int8. prune_margin
        drops probes trailing the query's best centroid by more than it.
        rerank re-scores that many scan candidates in true float32 (refine,
        int8 only, adds the residual store and defaults it to 256).
        scan_precision="highest" (float32 only) scans in true float32.
        use_fused defaults to True on a CUDA device."""
        if dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown dtype {dtype!r}")
        if scan_int4 and dtype != "int8":
            raise ValueError("int4 scan needs int8 storage")
        if refine and dtype != "int8":
            raise ValueError("refine needs int8 storage (float tiers have no quantization "
                             "residual)")
        if scan_precision not in ("default", "highest"):
            raise ValueError(f"unknown scan_precision {scan_precision!r}")
        if scan_precision == "highest" and dtype != "float32":
            raise ValueError(f"scan_precision='highest' requires float32 storage, got {dtype}")
        self.device = torch.device(device)
        self.refine = bool(refine)
        if self.refine and rerank is None:
            rerank = 256
        self.use_fused = self.device.type == "cuda" if use_fused is None else use_fused
        self.dim = dim
        self.C = n_clusters
        self.nprobe = min(nprobe, n_clusters)
        self.bucket_factor = bucket_factor
        self.seed = seed
        self.dtype = dtype
        self.prune_margin = prune_margin
        self.rerank = None if rerank is None else min(int(rerank), 1024)
        self.scan_precision = scan_precision
        self.centroids: torch.Tensor | None = None
        self.data: torch.Tensor | None = None
        self.rscales: torch.Tensor | None = None
        self.resid: torch.Tensor | None = None
        self.resid_scales: torch.Tensor | None = None
        self.sizes: torch.Tensor | None = None       # [C] int32 on the device
        self.rowids: np.ndarray | None = None        # [C, M] -> index into self.ids
        self._rowids_dev: torch.Tensor | None = None  # device rowid table (device builds)
        self.ids: list = []
        # One mean per index, pinned at the first host ingest and shared
        # with the spill; device-built corpora pin zero.
        self.center = True if center is None else bool(center)
        self.mean: np.ndarray | None = None
        # The spill never pins its own mean and shares the rerank depth.
        self.spill = FlatIndex(dim, dtype=dtype, center=False, rerank=self.rerank,
                               scan_precision=scan_precision, refine=self.refine,
                               device=self.device)
        self._deleted: set = set()
        self._live: set = set()
        self._ids_nulled = False  # an add() nulled stale table ids (delete -> re-add)
        self._base_dirty = False
        self._ckpt_path: str | None = None
        self._host_data: np.ndarray | None = None  # packed-table shadow
        self._host_scales: np.ndarray | None = None
        self._host_resid: np.ndarray | None = None
        self._host_resid_scales: np.ndarray | None = None
        self.needs_recovery = False  # set by load() when the base was skipped
        self.scan_int4 = scan_int4
        self._data4: torch.Tensor | None = None  # packed int4 mirror, built lazily
        self._rscales4: torch.Tensor | None = None

    @property
    def count(self) -> int:
        return len(self._live)

    def _sizes_host(self) -> np.ndarray:
        return self.sizes.cpu().numpy()

    def _int4_mirror(self):
        """Packed int4 mirror of the int8 table, built on first use after
        any table mutation; never persisted."""
        if self._data4 is None:
            self._data4, self._rscales4 = pack_int4_buckets(self.data, self.rscales,
                                                            banks=self._batch_banks())
        return self._data4, self._rscales4

    def _invalidate_int4(self) -> None:
        self._data4 = self._rscales4 = None

    def _batch_banks(self) -> int:
        """Chunk width of the batch-union scans: S = 1024 (8 banks) when the
        bucket allows, else 512 (pre-1024-alignment checkpoints)."""
        return 8 if self.data is not None and self.data.shape[1] % 1024 == 0 else 4

    def _pin_mean(self, vectors: np.ndarray | None) -> None:
        """Pin the shared quantization center (idempotent), before the first
        code lands in the table or the spill."""
        if self.mean is not None:
            return
        if self.center and vectors is not None and len(vectors):
            self.mean = np.asarray(vectors, np.float32).mean(axis=0)
        else:
            self.mean = np.zeros((self.dim,), np.float32)
        if self.spill.count and self.mean.any():
            raise RuntimeError("spill holds raw codes; cannot center after the fact")
        self.spill.mean = self.mean.copy()

    # -- build ---------------------------------------------------------------

    def _bucket_rows(self, counts: np.ndarray, at_least: int = 0) -> int:
        M = max(int(max(8, self.bucket_factor * max(1, counts.mean()))), at_least)
        return -(-M // 1024) * 1024  # the batch scans run S = 1024 chunks

    def build(self, vectors: np.ndarray, ids: list[str]) -> None:
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        if n != len(ids):
            raise ValueError(f"{n} vectors for {len(ids)} ids")
        self._live.update(ids)
        self._pin_mean(vectors)
        if n < self.C * 4:
            logger.info("ivf build: n=%d too small for C=%d, using spill only", n, self.C)
            self.spill.add(vectors, ids)
            return
        # Train on a subsample (scales with C, not N), then assign all rows
        # in blocks.
        TRAIN_CAP = max(self.C * 64, 65536)
        if n > TRAIN_CAP:
            rng = np.random.default_rng(self.seed)
            sample = vectors[rng.choice(n, TRAIN_CAP, replace=False)]
        else:
            sample = vectors
        self.centroids = kmeans_fit(torch.from_numpy(sample).to(self.device), self.C,
                                    seed=self.seed)
        assign = np.empty((n,), np.int64)
        for s in range(0, n, _BLOCK):
            assign[s : s + _BLOCK] = kmeans_assign(
                torch.from_numpy(vectors[s : s + _BLOCK]).to(self.device),
                self.centroids).cpu().numpy()
        counts = np.bincount(assign, minlength=self.C)
        M = self._bucket_rows(counts)
        order = np.argsort(assign, kind="stable")
        sorted_c = assign[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(n, dtype=np.int64) - starts[sorted_c]
        in_bucket = pos < M
        data = np.zeros((self.C, M, self.dim), np.float32)
        rowids = np.full((self.C, M), -1, np.int64)
        rows_sel = order[in_bucket]
        data[sorted_c[in_bucket], pos[in_bucket]] = vectors[rows_sel]
        rowids[sorted_c[in_bucket], pos[in_bucket]] = rows_sel
        self.ids = list(ids)
        self._ids_nulled = False
        if self.mean.any():
            # Centered storage: padding rows become -mean, which corrects
            # to a true score of exactly 0.
            data -= self.mean
        self._pack(data)
        self.sizes = torch.from_numpy(np.minimum(counts, M).astype(np.int32)).to(self.device)
        self.rowids = rowids
        self._rowids_dev = None
        self._base_dirty = True
        n_spill = int(n - in_bucket.sum())
        if n_spill:
            spill_rows = order[~in_bucket]
            logger.info("ivf build: %d bucket-overflow rows -> spill", n_spill)
            self.spill.add(vectors[spill_rows], [ids[i] for i in spill_rows])

    def build_device(self, vecs_q: torch.Tensor, scales: torch.Tensor, ids: list,
                     n_valid: int | None = None) -> None:
        """All-device build from an int8 corpus on the index's device:
        k-means on a dequantized sample, blockwise assignment, stable
        cluster sort and scatter into the buckets; only the counts come to
        the host. vecs_q [N, D] int8, scales [N] f32; rows at index >=
        n_valid are padding and never land. Overflow rows go to the spill
        and are folded into their next-nearest clusters with free slots."""
        if self.dtype != "int8":
            raise ValueError("device build packs int8 storage")
        if self.refine:
            raise ValueError("refine needs host-derived residual codes; device bulk builds "
                             "receive caller-quantized int8 only (no f32 source)")
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

        dev = vecs_q.device
        TRAIN_CAP = max(self.C * 64, 65536)
        m_samp = min(n_valid, TRAIN_CAP)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        samp_idx = torch.randperm(n_valid, generator=gen, device=dev)[:m_samp]
        sample = vecs_q[samp_idx].float() * scales[samp_idx, None]
        self.centroids = kmeans_fit(sample, self.C, seed=self.seed, generator=gen)
        del sample

        parts = []
        for s in range(0, n, _BLOCK):
            blk = (vecs_q[s : s + _BLOCK].to(torch.bfloat16)
                   * scales[s : s + _BLOCK, None].to(torch.bfloat16))
            parts.append(kmeans_assign(blk, self.centroids))
        assign = torch.cat(parts)
        if n_valid < n:
            # Padding rows sort to the tail (pseudo-cluster C) and drop.
            assign = torch.where(torch.arange(n, device=dev) < n_valid, assign, self.C)
        counts = torch.bincount(assign, minlength=self.C + 1)[: self.C].to(torch.int32)
        counts_h = counts.cpu().numpy()
        M = self._bucket_rows(counts_h)
        C = self.C

        dest, order = bucket_pack_dest(assign, counts, C, M)
        self.data, self.rscales, rid_cm = pack_scatter_int8(vecs_q, scales, dest, C, M)
        self._invalidate_int4()
        self.sizes = torch.clamp(counts, max=M).to(torch.int32)
        # The rowid table stays on the device: search maps winners with a
        # [Q, k] gather; save/compact fetch it (_rowids_host).
        self.rowids = None
        self._rowids_dev = rid_cm
        self.ids = list(ids)
        self._ids_nulled = False
        self._base_dirty = True
        self._host_data = self._host_scales = None  # device-resident only

        # Overflow rows: cluster c overflows sorted positions starts[c] + M
        # .. counts[c]; the codes move device to device into the spill.
        starts_h = np.concatenate([[0], np.cumsum(counts_h)[:-1]])
        over = np.nonzero(counts_h > M)[0]
        if len(over):
            sel = np.concatenate([np.arange(starts_h[c] + M, starts_h[c] + counts_h[c])
                                  for c in over])
            spill_rows = _take(order, sel)
            logger.info("ivf device build: %d bucket-overflow rows -> spill", len(sel))
            spill_ids = np.asarray(ids, dtype=object)[spill_rows.cpu().numpy()].tolist()
            self.spill.add_quantized(vecs_q[spill_rows], scales[spill_rows], spill_ids)
            folded = self.fold_spill()
            logger.info("ivf device build: folded %d/%d overflow rows into alternate "
                        "buckets (%d remain spilled)", folded, len(sel), self.spill.count)

    def _table_rows(self, cl: np.ndarray, sl: np.ndarray) -> np.ndarray:
        """Dequantized table rows at (cluster, slot), float32 on the host."""
        flat = torch.from_numpy(cl * self.data.shape[1] + sl).to(self.device)
        rows = self.data.reshape(-1, self.dim)[flat].float()
        return (rows * self.rscales.reshape(-1)[flat][:, None]).cpu().numpy()

    def _rowids_host(self) -> np.ndarray | None:
        """Host rowid table; device-built indexes fetch and cache it."""
        if self.rowids is None and self._rowids_dev is not None:
            self.rowids = self._rowids_dev.cpu().numpy().astype(np.int64)
        return self.rowids

    def _pack(self, data: np.ndarray) -> None:
        """[C, M, D] float32 -> device tensors in the storage dtype, with a
        host shadow of the packed table so save() reads no device bytes."""
        C, M, D = data.shape
        if self.dtype == "int8":
            if self.refine:
                from ..native_lib import np_quantize_rows_int8_refine

                q, s, rq, rs = np_quantize_rows_int8_refine(data.reshape(C * M, D))
                self._host_resid = rq.reshape(C, M, D)
                self._host_resid_scales = rs.reshape(C, M)
                self.resid = torch.from_numpy(self._host_resid).to(self.device)
                self.resid_scales = torch.from_numpy(self._host_resid_scales).to(self.device)
            else:
                from ..native_lib import np_quantize_rows_int8

                q, s = np_quantize_rows_int8(data.reshape(C * M, D))
            self._host_data = q.reshape(C, M, D)
            self._host_scales = s.reshape(C, M)
            self.data = torch.from_numpy(self._host_data).to(self.device)
            self.rscales = torch.from_numpy(self._host_scales).to(self.device)
        else:
            dt = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
            self.data = torch.from_numpy(data).to(self.device, dt)
            self.rscales = torch.ones((C, M), dtype=torch.float32, device=self.device)
            self._host_data = data.astype(np.float32)
            self._host_scales = None
        self._invalidate_int4()

    def add(self, vectors: np.ndarray, ids: list[str]) -> None:
        """Streaming ingest into the spill. Re-adding a deleted id
        un-deletes it: a stale table copy has its id nulled so it can never
        resurrect. Ids already live are no-ops."""
        vectors = np.asarray(vectors, np.float32)
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
        self._pin_mean(vectors)
        self.spill.add(vectors, ids)
        self._live.update(ids)

    def fold_spill(self) -> int:
        """Stream spill rows into the existing partitions in place: each row
        goes to the nearest cluster with a free slot among its top
        FOLD_CHOICES (current centroids, no retrain); rows that fit nowhere
        stay in the spill. Returns rows folded. int8 tables only."""
        if (self.dtype != "int8" or self.data is None or self.centroids is None
                or not self.spill.count):
            return 0
        C, M, D = self.data.shape
        sp = self.spill
        alive = sp.alive[: sp.count].cpu().numpy() > 0
        s_ids = np.asarray(sp.ids, dtype=object)[: sp.count]
        if self._deleted:
            alive &= ~np.isin(s_ids.astype(str), sorted(self._deleted))
        ssel = np.nonzero(alive)[0]
        n = len(ssel)
        if n == 0:
            sp.delete_all()
            return 0
        codes = _take(sp.buf, ssel)
        scales = _take(sp.scales, ssel)
        choice = _topk_clusters(codes, scales, self.centroids, n, min(self.FOLD_CHOICES, C),
                                mean=self.mean)
        a_final, slot_final, sizes_fill = _capacity_fill(choice, self._sizes_host(), M)
        ok = a_final >= 0
        dest = np.full((n,), C * M, np.int64)
        dest[ok] = a_final[ok] * M + slot_final[ok]
        n_fold = int(ok.sum())
        if n_fold == 0:
            return 0
        rid_new = len(self.ids) + np.arange(n)
        if self._rowids_dev is None:
            self._rowids_dev = torch.from_numpy(
                self._rowids_host().astype(np.int32)).to(self.device)
        dest_dev = torch.from_numpy(dest).to(self.device)
        _fold_scatter(self.data, self.rscales, self._rowids_dev, codes, scales, dest_dev,
                      torch.from_numpy(rid_new).to(self.device))
        if self.refine and self.resid is not None:
            _fold_scatter_resid(self.resid, self.resid_scales, _take(sp.rbuf, ssel),
                                _take(sp.rbuf_scales, ssel), dest_dev)
        if self.rowids is not None:
            self.rowids.reshape(-1)[dest[ok]] = rid_new[ok]
        self._invalidate_int4()
        self.sizes = torch.from_numpy(sizes_fill.astype(np.int32)).to(self.device)
        # Every gathered row gets a table id entry; unfolded rows keep None
        # there (their rowid never landed) and stay in the spill.
        sids_sel = s_ids[ssel]
        new_ids = np.full((n,), None, dtype=object)
        new_ids[ok] = sids_sel[ok]
        self.ids.extend(new_ids.tolist())
        # Host shadows: read the spill's before delete_all replaces them;
        # mirror the scatter when both sides are intact, else drop ours.
        sh_codes = sh_scales = sh_resid = sh_resid_sc = None
        if sp._sh_valid:
            sh_codes = sp._sh_rows[: sp.count][ssel]
            sh_scales = sp._sh_scales[: sp.count][ssel]
            if self.refine and sp._sh_resid is not None:
                sh_resid = sp._sh_resid[: sp.count][ssel]
                sh_resid_sc = sp._sh_resid_scales[: sp.count][ssel]
        if self._host_data is not None and sh_codes is not None:
            d_ok = dest[ok]
            self._host_data.reshape(C * M, D)[d_ok] = sh_codes[ok]
            self._host_scales.reshape(C * M)[d_ok] = sh_scales[ok]
            if self._host_resid is not None and sh_resid is not None:
                self._host_resid.reshape(C * M, D)[d_ok] = sh_resid[ok]
                self._host_resid_scales.reshape(C * M)[d_ok] = sh_resid_sc[ok]
        elif self._host_data is not None:
            self._host_data = self._host_scales = None
            self._host_resid = self._host_resid_scales = None
        # Rebuild the spill from the leftover rows, device to device. Ids
        # whose spill copies were dropped stay in `_deleted` (a deleted
        # table copy may share the id); rebuild() clears the set.
        left = ssel[~ok]
        left_ids = sids_sel[~ok].tolist()
        old_buf, old_scales = sp.buf, sp.scales
        old_rbuf, old_rbuf_sc = sp.rbuf, sp.rbuf_scales
        sp.delete_all()
        if self.mean is not None:
            sp.mean = self.mean.copy()  # delete_all un-pinned it
        if len(left):
            resid_dev = resid_sc_dev = None
            if self.refine and old_rbuf is not None:
                resid_dev, resid_sc_dev = _take(old_rbuf, left), _take(old_rbuf_sc, left)
            sp.add_quantized(
                _take(old_buf, left), _take(old_scales, left), left_ids,
                host_codes=sh_codes[~ok] if sh_codes is not None else None,
                host_scales=sh_scales[~ok] if sh_scales is not None else None,
                resid_dev=resid_dev, resid_scales_dev=resid_sc_dev,
                host_resid=sh_resid[~ok] if sh_resid is not None else None,
                host_resid_scales=sh_resid_sc[~ok] if sh_resid_sc is not None else None)
        self._base_dirty = True
        return n_fold

    def rebuild(self) -> None:
        """Fold the spill back into retrained partitions. int8 tables built
        on the device (zero mean, no refine store) rebuild on the device;
        the others on the host, re-pinning a fresh mean."""
        if (self.dtype == "int8" and self.data is not None and len(self._live) >= self.C * 4
                and not self.refine and (self.mean is None or not self.mean.any())):
            self.rebuild_device()
            return
        vecs, ids = self._all_vectors()
        # Full reset before build: below the C * 4 floor build() takes its
        # spill-only return, which must not leave the old table installed.
        self.delete_all()
        if len(ids):
            self.build(vecs, ids)

    # -- live-row extraction ----------------------------------------------------

    def _live_cluster_mask(self) -> np.ndarray:
        """[C, M] bool: slot holds a live (in-size, rowid-valid, undeleted,
        non-nulled-id) row."""
        rowids = self._rowids_host()
        sizes = self._sizes_host()
        M = rowids.shape[1]
        valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
        if self._deleted or self._ids_nulled:
            ids_arr = np.asarray(self.ids, dtype=object)
            sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
            if self._ids_nulled:
                valid &= np.not_equal(sids, None)
            if self._deleted:
                valid &= ~np.isin(sids.astype(str), sorted(self._deleted))
        return valid

    def _cluster_live_ids(self, valid: np.ndarray) -> list:
        """Ids of the selected bucket slots, row-major."""
        rid = self._rowids_host()[valid]
        return np.asarray(self.ids, dtype=object)[rid].tolist()

    def _all_vectors(self) -> tuple[np.ndarray, list]:
        """Every live row as a raw-space float32 vector, table then spill."""
        parts_v, parts_i = [], []
        if self.data is not None:
            valid = self._live_cluster_mask()
            if valid.any():
                data = (self.data.cpu().numpy() if self.dtype == "int8"
                        else self.data.float().cpu().numpy())
                sel = data[valid].astype(np.float32)
                if self.dtype == "int8":
                    sel *= self.rscales.cpu().numpy()[valid][:, None]
                    if self.refine and self.resid is not None:
                        # ~14-bit reconstruction: rebuild() re-quantizes it.
                        rq = (self._host_resid if self._host_resid is not None
                              else self.resid.cpu().numpy())
                        rs = (self._host_resid_scales if self._host_resid_scales is not None
                              else self.resid_scales.cpu().numpy())
                        sel += rq[valid].astype(np.float32) * rs[valid][:, None]
                if self.mean is not None and self.mean.any():
                    sel += self.mean  # rows are centered residuals
                parts_v.append(sel)
                parts_i.extend(self._cluster_live_ids(valid))
        if self.spill.count:
            alive = self.spill.alive[: self.spill.count].cpu().numpy() > 0
            svecs = self.spill._dequantized()[alive]
            sids = np.asarray(self.spill.ids, dtype=object)[: self.spill.count][alive]
            if self._deleted:
                keep = ~np.isin(sids.astype(str), sorted(self._deleted))
                svecs, sids = svecs[keep], sids[keep]
            parts_v.append(svecs)
            parts_i.extend(sids.tolist())
        if not parts_v:
            return np.zeros((0, self.dim), np.float32), []
        return np.concatenate(parts_v), parts_i

    def rebuild_device(self) -> None:
        """Device-side rebuild of an int8 table: the live bucket rows and
        the live spill rows are gathered into one compacted corpus on the
        device (the host sends only the selection), the table is freed,
        and build_device() retrains and repacks."""
        if self.dtype != "int8" or self.data is None:
            raise ValueError("device rebuild needs a resident int8 table")
        valid = self._live_cluster_mask()
        sel = np.nonzero(valid.reshape(-1))[0]
        ids_out: list = self._cluster_live_ids(valid)
        n_live = len(sel)
        sids: list = []
        ssel = np.zeros((0,), np.int64)
        if self.spill.count:
            s_alive = self.spill.alive[: self.spill.count].cpu().numpy() > 0
            s_ids = np.asarray(self.spill.ids, dtype=object)[: self.spill.count]
            if self._deleted:
                s_alive &= ~np.isin(s_ids.astype(str), sorted(self._deleted))
            ssel = np.nonzero(s_alive)[0]
            sids = s_ids[ssel].tolist()
        n_valid = n_live + len(ssel)
        all_codes = torch.empty((n_valid, self.dim), dtype=torch.int8, device=self.device)
        all_scales = torch.empty((n_valid,), dtype=torch.float32, device=self.device)
        sel_d = torch.from_numpy(sel).to(self.device)
        torch.index_select(self.data.view(-1, self.dim), 0, sel_d, out=all_codes[:n_live])
        torch.index_select(self.rscales.view(-1), 0, sel_d, out=all_scales[:n_live])
        # Free the table before the rebuild allocates the next one.
        self.data = self.rscales = self.sizes = None
        self._invalidate_int4()
        self.rowids = None
        self._rowids_dev = None
        if len(ssel):
            idx = torch.arange(n_live, n_valid, device=self.device)
            _land_rows(all_codes, all_scales, _take(self.spill.buf, ssel),
                       _take(self.spill.scales, ssel), idx)
        ids_all = ids_out + sids
        self.spill.delete_all()
        self._deleted.clear()
        self._live.clear()
        self.ids = []
        self.build_device(all_codes, all_scales, ids_all, n_valid=n_valid)

    # -- search --------------------------------------------------------------

    def _scan(self, q: torch.Tensor, kk: int):
        """The table's coarse top-kk: (vals, cluster, slot) [Q, kk].

        Eligibility (the port's; memex_tpu also gates on its TPU VMEM): the
        batch-union scan (K5, or K6 with scan_int4) when the candidate bank
        holds kk and the bucket is whole S-row chunks, at most 256 of them;
        else the per-query probe scan (K7) when kk <= 256 and M is a
        multiple of 256; else the plain scan. On the card a failed kernel
        raises: there is no fallback."""
        M = self.data.shape[1]
        banks = self._batch_banks()
        # keep2 (the best two rows per slot) for rerank callers and the
        # exact tier: two true top-k rows congruent mod S would otherwise
        # shadow each other in the single-winner fold.
        keep2 = bool(self.rerank) or self.scan_precision == "highest"
        Sk = banks * 128
        bank = (2 if keep2 else 1) * Sk
        if self.rerank and kk > bank:
            kk = bank  # a rerank deeper than the bank holds is moot
        if self.use_fused and kk <= bank and M % Sk == 0 and M // Sk <= 256:
            if self.scan_int4:
                data4, rsc4 = self._int4_mirror()
                res = ivf_batch_search4(self.centroids, data4, rsc4, self.data, self.rscales,
                                        self.sizes, q, self.nprobe, kk, banks=banks,
                                        prune_margin=self.prune_margin, keep2=keep2)
            else:
                res = ivf_batch_search(self.centroids, self.data, self.rscales, self.sizes, q,
                                       self.nprobe, kk, banks=banks,
                                       prune_margin=self.prune_margin,
                                       exact=self.scan_precision == "highest", keep2=keep2)
        elif self.use_fused and kk <= 256 and M % 256 == 0:
            res = _ivf_search_fused(self.centroids, self.data, self.rscales, self.sizes, q,
                                    self.nprobe, kk)
        else:
            res = _ivf_search(self.centroids, self.data, self.rscales, self.sizes, q,
                              self.nprobe, kk)
        return (*res, kk)

    def search(self, queries: np.ndarray, k: int) -> list[list[tuple[str, float]]]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        Q = queries.shape[0]
        merged: list[dict] = [dict() for _ in range(Q)]
        if self.data is not None:
            table_rows = int(self.sizes.sum())
            kk = min(k + len(self._deleted), table_rows)
            if self.rerank:
                kk = min(max(kk, self.rerank), table_rows)  # the exact re-score's bank
            if kk > 0:
                q = torch.from_numpy(queries).to(self.device)
                vals, cl, sl, kk = self._scan(q, kk)
                keep = min(k + len(self._deleted), kk)
                if self.rerank and kk > keep:
                    vals, cl, sl = _exact_topk_rerank(
                        self.data, self.rscales, q, vals, cl, sl, keep, resid=self.resid,
                        resid_scales=self.resid_scales)
                orig = None
                if self._rowids_dev is not None:
                    # Map winners to original rows on the device.
                    orig = self._rowids_dev.reshape(-1)[cl.long() * self.data.shape[1]
                                                        + sl.long()].cpu().numpy()
                vals, cl, sl = vals.cpu().numpy(), cl.cpu().numpy(), sl.cpu().numpy()
                # Centered codes: restore true cosines with q . mean.
                off = (queries @ self.mean
                       if self.mean is not None and self.mean.any() else None)
                for qi in range(Q):
                    for j, (v, c, s) in enumerate(zip(vals[qi], cl[qi], sl[qi])):
                        if v <= -1e29:
                            continue
                        ridx = orig[qi, j] if orig is not None else self.rowids[c, s]
                        if ridx < 0:
                            continue
                        sid = self.ids[ridx]
                        if sid is None or sid in self._deleted:
                            continue
                        merged[qi][sid] = float(v) + (float(off[qi]) if off is not None else 0.0)
        if self.spill.count:
            for qi, hits in enumerate(self.spill.search(queries, min(k, self.spill.count))):
                for sid, v in hits:
                    if sid not in self._deleted:
                        merged[qi][sid] = v
        return [[(sid, v) for sid, v in sorted(m.items(), key=lambda kv: -kv[1])[:k]]
                for m in merged]

    # -- persistence -----------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint: `{path}.npz` (centroids + live rows in storage
        precision + assignments + ids), `{path}.meta.json` (format 2) and
        `{path}.spill.*` (the spill's segment log). The base is written only
        when dirty. A device-built int8 base is not fetched (SQL recovers
        it; load() flags the index) unless MEMEX_CKPT_DEVICE_BASE=1."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        skip_base = (self.data is not None and self._host_data is None
                     and self.dtype == "int8"
                     and os.environ.get("MEMEX_CKPT_DEVICE_BASE") != "1")
        if skip_base:
            try:
                os.remove(path + ".npz")  # drop any stale base
            except FileNotFoundError:
                pass
        elif self._base_dirty or path != self._ckpt_path or not os.path.exists(path + ".npz"):
            arrs: dict[str, np.ndarray] = {
                "centroids": (self.centroids.cpu().numpy() if self.centroids is not None
                              else np.zeros((0, self.dim), np.float32)),
            }
            if self.data is not None:
                rowids = self._rowids_host()
                sizes = self._sizes_host()
                M = rowids.shape[1]
                # Deleted rows stay in the base (meta lists them); nulled-id
                # rows (stale copies killed by a re-add) are dropped here.
                valid = (np.arange(M)[None, :] < sizes[:, None]) & (rowids >= 0)
                if self._ids_nulled:
                    ids_arr = np.asarray(self.ids, dtype=object)
                    sids = ids_arr[np.clip(rowids, 0, len(self.ids) - 1)]
                    valid &= np.not_equal(sids, None)
                arrs["cluster_assign"] = np.nonzero(valid)[0].astype(np.int32)
                arrs["cluster_ids"] = np.asarray(
                    np.asarray(self.ids, dtype=object)[rowids[valid]].tolist())
                if self._host_data is not None:
                    arrs["cluster_codes" if self.dtype == "int8" else "cluster_vecs"] = \
                        self._host_data[valid]
                    if self.dtype == "int8":
                        arrs["cluster_scales"] = self._host_scales[valid]
                    if self.refine and self._host_resid is not None:
                        arrs["cluster_resid"] = self._host_resid[valid]
                        arrs["cluster_resid_scales"] = self._host_resid_scales[valid]
                elif self.dtype == "int8":
                    # Device-built table: compact the live rows on the device
                    # first, then fetch only their codes.
                    sel = torch.from_numpy(np.nonzero(valid.reshape(-1))[0]).to(self.device)
                    arrs["cluster_codes"] = self.data.view(-1, self.dim)[sel].cpu().numpy()
                    arrs["cluster_scales"] = self.rscales.view(-1)[sel].cpu().numpy()
                else:
                    arrs["cluster_vecs"] = self.data.float().cpu().numpy()[valid]
            else:
                arrs["cluster_assign"] = np.zeros((0,), np.int32)
                arrs["cluster_ids"] = np.zeros((0,), np.str_)
                arrs["cluster_vecs"] = np.zeros((0, self.dim), np.float32)
            np.savez(path + ".npz", **arrs)
            self._base_dirty = False
            self._ckpt_path = path
        meta = {
            "format": 2,
            "dim": self.dim,
            "n_clusters": self.C,
            "nprobe": self.nprobe,
            "bucket_factor": self.bucket_factor,
            "dtype": self.dtype,
            "refine": self.refine,
            "deleted": sorted(str(s) for s in self._deleted),
            "base_skipped": bool(skip_base),
        }
        if self.mean is not None:
            meta["mean"] = [float(x) for x in self.mean]
        tmp = path + ".meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(meta, fh)
        os.replace(tmp, path + ".meta.json")
        self.spill.save(path + ".spill")

    def _load_spill(self, path: str, deleted: set) -> None:
        self.spill = FlatIndex.load(path + ".spill", dtype=self.dtype, center=False,
                                    rerank=self.rerank, scan_precision=self.scan_precision,
                                    refine=self.refine, device=self.device)
        if deleted and self.spill.count:
            self.spill.delete([s for s in self.spill.ids if s in deleted])
        self._live.update(self.spill._id_to_row)

    def _install_base(self, centroids: np.ndarray, assign: np.ndarray, cids: list,
                      M: int) -> tuple[np.ndarray, np.ndarray]:
        """Centroids, sizes and rowids of a checkpointed base; returns the
        (cluster, slot) of each row (saved rows are cluster-sorted)."""
        self.centroids = torch.from_numpy(np.asarray(centroids, np.float32)).to(self.device)
        counts = np.bincount(assign, minlength=self.C)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(len(cids), dtype=np.int64) - starts[assign]
        rowids = np.full((self.C, M), -1, np.int64)
        rowids[assign, pos] = np.arange(len(cids))
        self.ids = list(cids)
        self.sizes = torch.from_numpy(counts.astype(np.int32)).to(self.device)
        self.rowids = rowids
        self._live.update(cids)
        return assign, pos

    @classmethod
    def load(cls, path: str, *, device: torch.device | str, **kw) -> "IVFIndex":
        with open(path + ".meta.json", "r", encoding="utf-8") as fh:
            meta = json.load(fh)
        kw.setdefault("n_clusters", meta["n_clusters"])
        kw.setdefault("nprobe", meta["nprobe"])
        kw.setdefault("bucket_factor", meta["bucket_factor"])
        kw.setdefault("dtype", meta.get("dtype", "float32"))
        kw.setdefault("refine", meta.get("refine", False))
        idx = cls(dim=meta["dim"], device=device, **kw)
        if meta.get("format") != 2:
            return cls._load_legacy(idx, path, meta)
        if "mean" in meta:
            # Before any code lands: base and spill are centered at it.
            idx.mean = np.asarray(meta["mean"], np.float32)
            idx.spill.mean = idx.mean.copy()
        deleted = set(meta.get("deleted", []))
        if meta.get("base_skipped") or not os.path.exists(path + ".npz"):
            # The device-built base was not persisted: restore the spill and
            # flag for SQL recovery.
            idx.needs_recovery = True
            if FlatIndex.exists(path + ".spill"):
                idx._load_spill(path, deleted)
            if idx.mean is not None and idx.spill.mean is None:
                idx.spill.mean = idx.mean.copy()
            idx._ckpt_path = path
            return idx
        arrs = np.load(path + ".npz")
        cids_arr = arrs["cluster_ids"]
        centroids = arrs["centroids"]
        if len(centroids) and len(cids_arr):
            assign = arrs["cluster_assign"]
            if deleted:
                keep = ~np.isin(cids_arr.astype(str), sorted(deleted))
                cids_arr, assign = cids_arr[keep], assign[keep]
                # The file still holds the deleted rows: the next save must
                # rewrite a compacted base.
                idx._base_dirty = True
            else:
                keep = slice(None)
            counts = np.bincount(assign, minlength=idx.C)
            M = idx._bucket_rows(counts, at_least=int(counts.max()))  # every saved row fits
            assign, pos = idx._install_base(centroids, assign, [str(s) for s in cids_arr], M)
            if "cluster_codes" in arrs:
                # int8 bases restore the exact stored codes.
                codes = np.zeros((idx.C, M, idx.dim), np.int8)
                rsc = np.zeros((idx.C, M), np.float32)
                codes[assign, pos] = arrs["cluster_codes"][keep]
                rsc[assign, pos] = arrs["cluster_scales"][keep]
                idx.data = torch.from_numpy(codes).to(idx.device)
                idx.rscales = torch.from_numpy(rsc).to(idx.device)
                idx._host_data, idx._host_scales = codes, rsc
                if idx.refine and "cluster_resid" in arrs:
                    rq = np.zeros((idx.C, M, idx.dim), np.int8)
                    rs2 = np.zeros((idx.C, M), np.float32)
                    rq[assign, pos] = arrs["cluster_resid"][keep]
                    rs2[assign, pos] = arrs["cluster_resid_scales"][keep]
                    idx.resid = torch.from_numpy(rq).to(idx.device)
                    idx.resid_scales = torch.from_numpy(rs2).to(idx.device)
                    idx._host_resid, idx._host_resid_scales = rq, rs2
            else:
                data = np.zeros((idx.C, M, idx.dim), np.float32)
                data[assign, pos] = arrs["cluster_vecs"][keep]
                idx._pack(data)
        if FlatIndex.exists(path + ".spill"):
            idx._load_spill(path, deleted)
            if idx.spill.needs_recovery:
                idx.needs_recovery = True  # device-built spill rows were skipped
        if idx.mean is None and (idx.data is not None or idx.spill.count):
            # Pre-centering checkpoint: codes are raw, pin zero.
            idx.mean = np.zeros((idx.dim,), np.float32)
        if idx.mean is not None and idx.spill.mean is None:
            idx.spill.mean = idx.mean.copy()
        idx._ckpt_path = path
        return idx

    @classmethod
    def _load_legacy(cls, idx: "IVFIndex", path: str, meta: dict) -> "IVFIndex":
        """Round-1 single-npz format (dequantized float32 rows)."""
        arrs = np.load(path + ".npz")
        cids: list[str] = meta["cluster_ids"]
        centroids = arrs["centroids"]
        if len(centroids) and len(cids):
            assign = arrs["cluster_assign"]
            counts = np.bincount(assign, minlength=idx.C)
            M = idx._bucket_rows(counts, at_least=int(counts.max()))
            assign, pos = idx._install_base(centroids, assign, list(cids), M)
            data = np.zeros((idx.C, M, idx.dim), np.float32)
            data[assign, pos] = arrs["cluster_vecs"]
            idx._pack(data)
        sids = meta["spill_ids"]
        if sids:
            idx.spill.add(arrs["spill_vecs"], sids)
            idx._live.update(sids)
        return idx

    @classmethod
    def exists(cls, path: str) -> bool:
        if not os.path.exists(path + ".meta.json"):
            return False
        if os.path.exists(path + ".npz"):
            return True
        try:
            with open(path + ".meta.json", "r", encoding="utf-8") as fh:
                return bool(json.load(fh).get("base_skipped"))
        except (OSError, json.JSONDecodeError):
            return False

    @classmethod
    def remove_checkpoint(cls, path: str) -> None:
        FlatIndex.remove_checkpoint(path + ".spill")
        for suffix in (".npz", ".meta.json"):
            try:
                os.remove(path + suffix)
            except FileNotFoundError:
                pass

    def delete(self, ids: list[str]) -> int:
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
        self.data = None
        self.rscales = None
        self.resid = None
        self.resid_scales = None
        self.sizes = None
        self.rowids = None
        self._rowids_dev = None
        self.ids = []
        self._ids_nulled = False
        self._deleted.clear()
        self._live.clear()
        self.spill.delete_all()
        self.mean = None  # re-pinned at the next ingest
        self._base_dirty = True
        self._host_data = self._host_scales = None
        self._host_resid = self._host_resid_scales = None
        self._invalidate_int4()

    def calibrate_margin(self, queries: np.ndarray | None = None, k: int = 10,
                         target_overlap: float = 0.97, margins=None, n_queries: int = 64,
                         seed: int = 0, target_metric: str = "overlap") -> float | None:
        """Auto-tune prune_margin to a recall target; see calibrate_prune_margin."""
        return calibrate_prune_margin(self, queries=queries, k=k, target_overlap=target_overlap,
                                      margins=margins, n_queries=n_queries, seed=seed,
                                      target_metric=target_metric)

    def calibrate_operating_point(self, queries: np.ndarray | None = None, k: int = 10,
                                  target_recall: float = 0.95, nprobes=None,
                                  n_queries: int = 64, seed: int = 0,
                                  margins=None) -> dict | None:
        """Jointly pick (nprobe, prune_margin) against a recall floor; see
        calibrate_operating_point."""
        return calibrate_operating_point(self, queries=queries, k=k,
                                         target_recall=target_recall, nprobes=nprobes,
                                         n_queries=n_queries, seed=seed, margins=margins)


def ivf_state_from_numpy(index: IVFIndex, *, centroids, data, rscales, sizes, rowids, ids,
                         mean=None, resid=None, resid_scales=None) -> IVFIndex:
    """Install a cluster table given as numpy arrays (memex_tpu's
    IVFIndex arrays: centroids [C, D], data [C, M, D] in the storage dtype
    or float32, rscales [C, M], sizes [C], rowids [C, M] host table, ids,
    the pinned mean, and the refinement store) into `index`, replacing its
    table; the spill is untouched. For tests that hold both packages to
    the same table. Returns `index`."""
    dev = index.device
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[index.dtype]
    index.centroids = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
    index.data = torch.from_numpy(np.array(data, np.float32 if dt != torch.int8
                                           else np.int8)).to(dev, dt)
    index.rscales = torch.from_numpy(np.array(rscales, np.float32)).to(dev)
    index.sizes = torch.from_numpy(np.array(sizes, np.int32)).to(dev)
    index.rowids = np.array(rowids, np.int64)
    index._rowids_dev = None
    index.ids = list(ids)
    index._ids_nulled = any(sid is None for sid in index.ids)
    index._live.update(sid for sid in index.ids if sid is not None)
    if mean is not None:
        index.mean = np.asarray(mean, np.float32)
        index.spill.mean = index.mean.copy()
    if resid is not None:
        index.resid = torch.from_numpy(np.array(resid, np.int8)).to(dev)
        index.resid_scales = torch.from_numpy(np.array(resid_scales, np.float32)).to(dev)
    index._host_data = index._host_scales = None
    index._host_resid = index._host_resid_scales = None
    index._base_dirty = True
    index._invalidate_int4()
    return index


# -- prune-margin auto-calibration ---------------------------------------------

# Ascending sweep grid: the first (smallest, most aggressive) margin holding
# the overlap target wins. Cosine units; 0.5 is nearly keep-all on
# clustered corpora.
CALIBRATION_MARGINS = (0.05, 0.08, 0.12, 0.17, 0.25, 0.35, 0.5)


def sample_corpus_queries(index, n: int, seed: int = 0) -> np.ndarray | None:
    """n probe queries drawn from the index's own cluster table (dequantized
    rows, re-normalized): real queries land where the corpus is dense."""
    if index.data is None:
        return None
    sizes = index._sizes_host()
    live = np.nonzero(sizes > 0)[0]
    if live.size == 0:
        return None
    rng = np.random.default_rng(seed)
    cl = rng.choice(live, size=n)
    sl = np.floor(rng.random(n) * sizes[cl]).astype(np.int64)
    q = index._table_rows(cl, sl)
    mean = getattr(index, "mean", None)
    if mean is not None and np.asarray(mean).any():
        q = q + np.asarray(mean, np.float32)  # codes are centered residuals
    nrm = np.linalg.norm(q, axis=1, keepdims=True)
    return q / np.maximum(nrm, 1e-9)


def _overlap(base_sets, hits) -> float:
    return float(np.mean([len(base_sets[i] & {sid for sid, _ in hits[i]})
                          / max(len(base_sets[i]), 1) for i in range(len(base_sets))]))


def calibrate_prune_margin(index, queries: np.ndarray | None = None, k: int = 10,
                           target_overlap: float = 0.97, margins=None, n_queries: int = 64,
                           seed: int = 0, target_metric: str = "overlap") -> float | None:
    """Pick the smallest prune margin whose pruned top-k keeps >=
    target_overlap of the baseline on probe queries, set it as
    index.prune_margin and return it. Baseline: the unpruned search
    ("overlap") or a full-probe search ("recall", routing loss included).
    None (pruning off) when no margin meets the target or there is no
    cluster table."""
    if target_metric not in ("overlap", "recall"):
        raise ValueError(f"unknown target_metric {target_metric!r}")
    if margins is None:
        margins = CALIBRATION_MARGINS
    if queries is None:
        queries = sample_corpus_queries(index, n_queries, seed=seed)
    if queries is None:
        index.prune_margin = None
        return None
    prev = index.prune_margin
    prev_nprobe = index.nprobe
    index.prune_margin = None
    if target_metric == "recall":
        index.nprobe = index.C
    try:
        base = index.search(queries, k)
    except Exception:
        index.prune_margin = prev
        raise
    finally:
        index.nprobe = prev_nprobe
    base_sets = [frozenset(sid for sid, _ in hits) for hits in base]
    for m in sorted(margins):
        index.prune_margin = float(m)
        overlap = _overlap(base_sets, index.search(queries, k))
        if overlap >= target_overlap:
            logger.info("prune_margin calibrated: %.3f (overlap %.3f >= %.2f)",
                        m, overlap, target_overlap)
            return index.prune_margin
    index.prune_margin = None
    logger.info("prune_margin calibration: no margin held overlap >= %.2f; pruning disabled",
                target_overlap)
    return None


def _nprobe_ladder(start: int, C: int) -> list[int]:
    """Doubling ladder from the configured nprobe up to C; the last rung
    (full probe) holds any recall target."""
    ladder, v = [], max(1, int(start))
    while v < C:
        ladder.append(v)
        v *= 2
    ladder.append(C)
    return ladder


def calibrate_operating_point(index, queries: np.ndarray | None = None, k: int = 10,
                              target_recall: float = 0.95, nprobes=None, n_queries: int = 64,
                              seed: int = 0, margins=None) -> dict | None:
    """Jointly pick (nprobe, prune_margin) against a recall floor: the
    smallest ladder nprobe whose unpruned search holds target_recall
    against a full-probe baseline, then the margin sweep at that nprobe.
    Sets both on the index and returns {"nprobe", "prune_margin",
    "recall_vs_full", "sweep"}, or None without a cluster table. A failure
    mid-sweep restores the previous operating point."""
    if queries is None:
        queries = sample_corpus_queries(index, n_queries, seed=seed)
    if queries is None:
        return None
    prev_nprobe, prev_margin = index.nprobe, index.prune_margin
    index.prune_margin = None
    index.nprobe = index.C
    try:
        base = index.search(queries, k)
    except Exception:
        index.nprobe, index.prune_margin = prev_nprobe, prev_margin
        raise
    base_sets = [frozenset(sid for sid, _ in hits) for hits in base]
    if nprobes is None:
        nprobes = _nprobe_ladder(prev_nprobe, index.C)
    ladder = sorted({int(x) for x in nprobes if 0 < int(x) <= index.C}) or [index.C]
    sweep: list[dict] = []
    try:
        for cand in ladder:
            index.nprobe = cand
            rec = 1.0 if cand == index.C else _overlap(base_sets, index.search(queries, k))
            sweep.append({"nprobe": cand, "recall_vs_full": round(rec, 4)})
            if rec >= target_recall:
                break
        margin = calibrate_prune_margin(index, queries=queries, k=k,
                                        target_overlap=target_recall, margins=margins,
                                        target_metric="recall")
    except Exception:
        index.nprobe, index.prune_margin = prev_nprobe, prev_margin
        raise
    point = {"nprobe": index.nprobe, "prune_margin": margin,
             "recall_vs_full": sweep[-1]["recall_vs_full"], "sweep": sweep}
    logger.info("operating point calibrated: nprobe=%d margin=%s (recall %.3f >= %.2f vs "
                "full probe)", index.nprobe, margin, sweep[-1]["recall_vs_full"],
                target_recall)
    return point
