"""The port's FlatIndex against memex_tpu's on the CPU: the same ingest,
search, delete and compaction sequence gives the same hits, and either
package loads the other's checkpoint with identical rows, ids and mean,
for every storage tier (float32, bfloat16, int8 with and without query
quantization, int4, each with rerank or refine where it applies).

The fused branches run too: memex_tpu's Pallas kernels in interpret mode,
the port's plain versions of K1-K4 (CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.index.flat import FlatIndex as JaxFlat
from memex_tpu_torch.index.flat import FlatIndex as TorchFlat
from memex_tpu_torch.ops import fused_topk as ft

torch.set_num_threads(2)

DIM = 32
# Scores: identical (bf16-rounded or float32) inputs summed in a different
# order, plus the same host-side q.mean: float32 noise.
SCORE_ATOL = 2e-5


def _unit(rng, n, d=DIM):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(**kw):
    jax_idx = JaxFlat(DIM, **kw)
    jax_idx._interpret = True  # Pallas kernels in interpret mode on the CPU
    return jax_idx, TorchFlat(DIM, device="cpu", **kw)


def _same_hits(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [sid for sid, _ in ha] == [sid for sid, _ in hb]
        np.testing.assert_allclose([s for _, s in ha], [s for _, s in hb],
                                   rtol=0, atol=SCORE_ATOL)


CONFIGS = [
    dict(dtype="float32", use_fused=False),
    dict(dtype="float32", use_fused=True),
    dict(dtype="bfloat16", use_fused=True),
    dict(dtype="float32", use_fused=True, rerank=16),
    dict(dtype="float32", use_fused=True, scan_precision="highest"),
    dict(dtype="bfloat16", use_fused=False, rerank=16),
    dict(dtype="int8", use_fused=True),
    dict(dtype="int8", use_fused=True, query_quantize=False),
    dict(dtype="int8", use_fused=True, rerank=16),
    dict(dtype="int8", use_fused=True, refine=True),
    dict(dtype="int8", use_fused=False, refine=True),
    dict(dtype="int4", use_fused=True),
    dict(dtype="int4", use_fused=True, refine=True),
    dict(dtype="int4", use_fused=False),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_lifecycle_matches_jax(cfg):
    rng = np.random.default_rng(0)
    jx, tx = _pair(**cfg)
    vecs = _unit(rng, 1500)
    ids = [f"v{i}" for i in range(1500)]
    for lo, hi in ((0, 300), (300, 1100), (1100, 1500)):
        batch_ids = ids[lo:hi] + [ids[lo]]          # intra-batch duplicate
        batch = np.concatenate([vecs[lo:hi], vecs[lo:lo + 1] * 0.5])
        if lo:
            batch_ids.append(ids[0])                # idempotent re-add
            batch = np.concatenate([batch, vecs[:1]])
        jx.add(batch, batch_ids)
        tx.add(batch, batch_ids)
    assert tx.count == jx.count and tx.capacity == jx.capacity
    assert tx.ids == jx.ids
    np.testing.assert_array_equal(tx.mean, jx.mean)  # pinned at the first ingest
    q = _unit(rng, 5)
    for k in (1, 10):
        _same_hits(jx.search(q, k), tx.search(q, k))
    # Tombstones below the compaction threshold: the scans mask them.
    dead = [f"v{i}" for i in rng.choice(1500, 100, replace=False)]
    assert jx.delete(dead) == tx.delete(dead) == 100
    assert tx.dead == jx.dead == 100
    hits = tx.search(q, 10)
    _same_hits(jx.search(q, 10), hits)
    assert not {sid for h in hits for sid, _ in h} & set(dead)
    # Past 25% dead: compaction repacks, keeping the pinned mean.
    more = [f"v{i}" for i in range(1500) if f"v{i}" not in set(dead)][:300]
    jx.delete(more)
    tx.delete(more)
    assert tx.dead == jx.dead == 0 and tx.count == jx.count == 1100
    assert tx.ids == jx.ids
    np.testing.assert_array_equal(tx.mean, jx.mean)
    _same_hits(jx.search(q, 10), tx.search(q, 10))
    # k wider than the fused candidate bank takes the plain path.
    _same_hits(jx.search(q, 200), tx.search(q, 200))


def test_tombstone_shortfall_rerun_matches_jax():
    """Deletes concentrated in a query's neighbourhood crowd the fused
    candidate list; both packages rerun on the plain path and still
    return k live hits."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(use_fused=True)
    base = _unit(rng, 1)
    near = base + 0.05 * rng.standard_normal((400, DIM)).astype(np.float32)
    vecs = np.concatenate([near / np.linalg.norm(near, axis=1, keepdims=True),
                           _unit(rng, 1800)])
    ids = [f"r{i}" for i in range(len(vecs))]
    jx.add(vecs, ids)
    tx.add(vecs, ids)
    dead = ids[:390]  # the 390 nearest rows, under the 25% compaction bar
    jx.delete(dead)
    tx.delete(dead)
    hj, ht = jx.search(base, 10), tx.search(base, 10)
    _same_hits(hj, ht)
    assert len(ht[0]) == 10


def test_centering_off_and_empty_index():
    rng = np.random.default_rng(2)
    jx, tx = _pair(center=False)
    assert tx.search(_unit(rng, 2), 5) == [[], []]
    vecs = _unit(rng, 100)
    jx.add(vecs, [str(i) for i in range(100)])
    tx.add(vecs, [str(i) for i in range(100)])
    assert not tx.mean.any()
    _same_hits(jx.search(vecs[:3], 7), tx.search(vecs[:3], 7))
    tx.delete_all()
    assert tx.count == 0 and tx.mean is None


def _fill(idx, rng, n, start=0):
    vecs = _unit(rng, n)
    idx.add(vecs, [f"c{i}" for i in range(start, start + n)])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_interchange(tmp_path, writer):
    """A checkpoint written by either package (incremental segments, dead
    rows) loads in the other with identical rows, ids and mean."""
    rng = np.random.default_rng(3)
    src = JaxFlat(DIM) if writer == "jax" else TorchFlat(DIM, device="cpu")
    path = str(tmp_path / "col.flat")
    _fill(src, rng, 500)
    src.save(path)
    _fill(src, rng, 300, start=500)  # appended as a second segment
    src.delete(["c3", "c600"])
    src.save(path)
    dst = (TorchFlat.load(path, device="cpu") if writer == "jax" else JaxFlat.load(path))
    assert dst.ids == [sid for sid in src.ids if sid not in ("c3", "c600")]
    keep = [i for i, sid in enumerate(src.ids) if sid not in ("c3", "c600")]

    def rows(idx):
        buf = idx.buf.float().numpy() if isinstance(idx.buf, torch.Tensor) else np.asarray(idx.buf)
        return buf[: idx.count]

    np.testing.assert_array_equal(rows(dst), rows(src)[keep])
    np.testing.assert_array_equal(dst.mean, src.mean)
    q = _unit(rng, 3)
    src_hits = [[h for h in hs if h[0] not in ("c3", "c600")] for hs in src.search(q, 12)]
    dst_hits = dst.search(q, 10)
    _same_hits([h[:10] for h in src_hits], dst_hits)
    assert TorchFlat.exists(path) and JaxFlat.exists(path)
    TorchFlat.remove_checkpoint(path)
    assert not JaxFlat.exists(path) and not list(tmp_path.iterdir())


def _stored(idx):
    """The live prefix as stored: rows (int8 codes or float32), scales and
    residual codes, from the host shadow, in either package."""
    scales = idx._raw_scales()
    rq, rs = idx._raw_resid()
    return [np.asarray(a) for a in (idx._raw_rows(), scales, rq, rs) if a is not None]


def _packed_rows(idx):
    """An int4 index's packed rows [count, D/2], in the port's layout."""
    if isinstance(idx.buf, torch.Tensor):
        return idx.buf[: idx.count].numpy()
    return np.asarray(idx.buf)[:, : idx.count].T


QUANT_TIERS = [dict(dtype="int8"), dict(dtype="int8", refine=True), dict(dtype="int4"),
               dict(dtype="int4", refine=True)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("tier", QUANT_TIERS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_quantized_checkpoint_interchange(tmp_path, tier, writer):
    """Quantized checkpoints (int8 codes, scales, residual codes) load in
    the other package with identical stored rows; int4 re-derives its
    packed rows from the int8 codes in both packages alike."""
    rng = np.random.default_rng(4)
    src = JaxFlat(DIM, **tier) if writer == "jax" else TorchFlat(DIM, device="cpu", **tier)
    path = str(tmp_path / "col.flat")
    _fill(src, rng, 500)
    src.save(path)
    _fill(src, rng, 300, start=500)
    src.delete(["c3", "c600"])
    src.save(path)
    dst = TorchFlat.load(path, device="cpu") if writer == "jax" else JaxFlat.load(path)
    assert dst.dtype == tier["dtype"] and dst.refine == tier.get("refine", False)
    keep = [i for i, sid in enumerate(src.ids) if sid not in ("c3", "c600")]
    assert dst.ids == [src.ids[i] for i in keep]
    for a, b in zip(_stored(dst), _stored(src), strict=True):
        np.testing.assert_array_equal(a, b[keep])
    np.testing.assert_array_equal(dst.mean, src.mean)
    tx = dst if writer == "jax" else TorchFlat.load(path, device="cpu")
    codes = tx._raw_rows()
    live8 = (tx.buf8 if tier["dtype"] == "int4" else tx.buf)[: tx.count].numpy()
    np.testing.assert_array_equal(live8, codes)  # the device buffer holds the codes
    if tier["dtype"] == "int4":
        jx = JaxFlat.load(path)
        np.testing.assert_array_equal(_packed_rows(tx), _packed_rows(jx))
        np.testing.assert_array_equal(_packed_rows(tx), ft.pack_int4_from_int8(codes))
    q = _unit(rng, 3)
    src_hits = [[h for h in hs if h[0] not in ("c3", "c600")] for hs in src.search(q, 12)]
    _same_hits([h[:10] for h in src_hits], dst.search(q, 10))


@pytest.mark.parametrize("refine", [False, True])
def test_add_quantized_then_rows_skipped_checkpoint(tmp_path, refine):
    """Rows inserted on the device (add_quantized) leave no host shadow:
    search sees them in both packages alike, and the next checkpoint
    records rows_skipped, which either package loads as an empty index
    flagged for recovery from SQL, keeping the pinned mean."""
    rng = np.random.default_rng(5)
    jx, tx = _pair(dtype="int8", use_fused=True, refine=refine)
    vecs = _unit(rng, 300)
    codes, scales = ft.quantize_rows_int8(torch.from_numpy(vecs))
    ids = [f"d{i}" for i in range(300)]
    # 300 codes, of which the first 290 land (the tail is bucket padding).
    jx.add_quantized(jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()), ids,
                     n_valid=290)
    tx.add_quantized(codes, scales, ids, n_valid=290)
    assert tx.count == jx.count == 290 and not tx.mean.any()
    more = _unit(rng, 100)
    jx.add(more, [f"h{i}" for i in range(100)])
    tx.add(more, [f"h{i}" for i in range(100)])
    q = np.concatenate([vecs[:3], more[:2]])
    _same_hits(jx.search(q, 10), tx.search(q, 10))
    loaders = ((JaxFlat.load, {}), (TorchFlat.load, dict(device="cpu")))
    for writer in (jx, tx):
        path = str(tmp_path / f"{type(writer).__module__.split('.')[0]}.flat")
        writer.save(path)
        for load, kw in loaders:
            back = load(path, **kw)
            assert back.needs_recovery and back.count == 0
            # The rows_skipped meta records no refine flag (memex_tpu's
            # format): a store passes it again from its URI.
            assert back.dtype == "int8" and not back.refine
            assert load(path, refine=refine, **kw).refine == refine
            np.testing.assert_array_equal(back.mean, tx.mean)
    # With the host codes passed along the shadow stays valid, and the
    # checkpoint holds every row.
    tv = TorchFlat(DIM, device="cpu", dtype="int8", refine=refine)
    tv.add_quantized(codes, scales, ids, host_codes=codes.numpy(), host_scales=scales.numpy())
    tv.save(str(tmp_path / "full.flat"))
    back = JaxFlat.load(str(tmp_path / "full.flat"))
    assert not back.needs_recovery and back.ids == ids
    np.testing.assert_array_equal(back._raw_rows(), codes.numpy())
    with pytest.raises(ValueError):
        TorchFlat(DIM, device="cpu", dtype="int4").add_quantized(codes, scales, ids)


def test_constructor_rejects_what_memex_tpu_asserts():
    for kw in (dict(dtype="int4"), dict(dtype="int8"), dict(dtype="int8", refine=True),
               dict(dtype="int4", refine=True)):
        assert TorchFlat(DIM, device="cpu", **kw).dtype == kw["dtype"]
    for kw in (dict(refine=True), dict(dtype="bfloat16", refine=True),
               dict(dtype="int8", scan_precision="highest"),
               dict(dtype="bfloat16", scan_precision="highest"), dict(dtype="float16")):
        with pytest.raises(ValueError):
            TorchFlat(DIM, device="cpu", **kw)
    with pytest.raises(ValueError):
        TorchFlat(DIM + 1, device="cpu", dtype="int4")
    assert TorchFlat(DIM, device="cpu", dtype="int8", refine=True).rerank == 128
