"""The port's FlatIndex against memex_tpu's on the CPU: the same ingest,
search, delete and compaction sequence gives the same hits, and either
package loads the other's checkpoint with identical rows, ids and mean.

The fused branch runs too: memex_tpu's Pallas kernel in interpret mode,
the port's plain K1 (CPU tensors)."""

import numpy as np
import pytest
import torch

from memex_tpu.index.flat import FlatIndex as JaxFlat
from memex_tpu_torch.index.flat import FlatIndex as TorchFlat

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


def test_unported_tiers_raise():
    for kw in (dict(dtype="int8"), dict(dtype="int4"), dict(refine=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TorchFlat(DIM, device="cpu", **kw)
    with pytest.raises(ValueError):
        TorchFlat(DIM, device="cpu", dtype="bfloat16", scan_precision="highest")
