"""The port's ShardedIVFIndex (memex_tpu_torch/index/sharded_ivf.py) over 8
`cpu` shards against memex_tpu's over its 8 virtual devices
(tests/conftest.py), on the same numpy inputs: the counterparts of
tests/test_sharded_ivf.py's cases (build, spill, fold, rebuild, deletes,
refine, centering, checkpoints) as parity checks, with the batch-union
scan (memex_tpu's Pallas kernel in interpret mode, the port's plain
version of K5) and with the dense scan; the exact fallback; calibration;
checkpoints in both directions, and the two reference faults the port
keeps; then the `tpu+ivf+mesh://` store: registry, memex_tpu's inline
maintenance rules, the runtime's Maintain wiring and batcher warmup.

jax.random's draws are not torch's: the port is handed memex_tpu's
training sample and k-means initialisation (`_train_sample`,
`kmeans_fit(init=...)`). Tolerances: hit ids equal (ids within 2e-5 of
each other's score may trade places); scores within 2e-5 (the same
bf16-rounded or integer operands, or the refine rescore's float32 ones,
summed in another order, plus the host-side q . mean)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import memex_tpu_torch.index.sharded_ivf as tsivf
from memex_tpu.index.sharded_ivf import ShardedIVFIndex as JaxSIVF
from memex_tpu_torch.index.flat import FlatIndex as TorchFlat
from memex_tpu_torch.index.sharded_ivf import ShardedIVFIndex as TorchSIVF

torch.set_num_threads(2)

D, P = 32, 8
SCORE_ATOL = 2e-5
CPU8 = ["cpu"] * P
_FIT = tsivf.kmeans_fit


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < P:
        pytest.skip("needs memex_tpu's 8 virtual devices (tests/conftest.py)")
    return Mesh(np.array(jax.devices()[:P]), ("shard",))


@pytest.fixture(autouse=True)
def shared_draws(monkeypatch):
    """The port trains on memex_tpu's sample from memex_tpu's initial rows."""
    def sample(n_valid, m, gen):
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.array(jax.random.choice(key, n_valid, (m,), replace=False)))

    def fit(vectors, n_clusters, iters=10, seed=0, **kw):
        n = vectors.shape[0]
        init = np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,),
                                          replace=n < n_clusters))
        return _FIT(vectors, n_clusters, iters, seed, init=torch.from_numpy(init))

    monkeypatch.setattr(tsivf, "_train_sample", sample)
    monkeypatch.setattr(tsivf, "kmeans_fit", fit)


def clustered(rng, n, d=D, centers=12, sigma=0.07):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + sigma * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(mesh, d=D, **kw):
    kw.setdefault("n_clusters", 16)
    kw.setdefault("nprobe", 6)
    kw.setdefault("use_fused", False)
    jx = JaxSIVF(d, mesh, interpret=True, **kw)
    jx.spill._interpret = True  # the spill's K2, in interpret mode too
    return jx, TorchSIVF(d, CPU8, **kw)


def same_hits(a, b, atol=SCORE_ATOL):
    """memex_tpu's hits `a` and the port's `b`: scores within atol place by
    place, ids equal except where a near-tie lets two trade places."""
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb)
        sa = np.array([s for _, s in ha])
        sb = np.array([s for _, s in hb])
        np.testing.assert_allclose(sb, sa, rtol=0, atol=atol)
        for i, ((ia, _), (ib, _)) in enumerate(zip(ha, hb)):
            if ia != ib:
                near = {hb[j][0] for j in range(len(hb)) if abs(sb[j] - sa[i]) <= 2 * atol}
                assert ia in near or abs(sa[i] - sa[-1]) <= 2 * atol, (i, ha, hb)


def _same_table(jx, tx):
    """Same centroids (k-means from one init, float32 sums in another
    order: 1e-5), sizes, rowids, ids and codes, shard by shard. memex_tpu's
    rebuild pads its corpus (and so its id table) to a multiple of 65536
    rows for its static shapes; the port's id table stops at the last row."""
    np.testing.assert_allclose(tx.centroids.numpy(), np.asarray(jx.centroids), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tx._sizes_h, np.asarray(jx.sizes))
    np.testing.assert_array_equal(tx._rowids_host(), np.asarray(jx._rowids_dev))
    np.testing.assert_array_equal(torch.cat(tx.data).numpy(), np.asarray(jx.data))
    n = len(tx.ids)
    assert tx.ids == jx.ids[:n] and not any(jx.ids[n:])
    assert tx._live == jx._live and tx.spill.count == jx.spill.count


def _recall(hits, exact, k=10):
    return np.mean([len({int(s[1:]) for s, _ in hits[i][:k]} & set(exact[i].tolist())) / k
                    for i in range(len(hits))])


CONFIGS = [
    dict(use_fused=True),
    dict(use_fused=False),
    dict(use_fused=True, refine=True),
    dict(use_fused=False, refine=True),
    dict(use_fused=True, prune_margin=0.1),
    dict(use_fused=True, center=False),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_lifecycle_matches_jax(mesh, cfg):
    """Build (clusters on every shard), search, stream a spill, delete
    from table and spill, fold in place, delete -> re-add, rebuild: the
    same tables and hits at every step (tests/test_sharded_ivf.py's
    build, spill/rebuild, delete-across-rebuild and fold cases)."""
    rng = np.random.default_rng(5)
    db = clustered(rng, 4096)
    ids = [f"v{i}" for i in range(4096)]
    qs = clustered(rng, 8)
    jx, tx = _pair(mesh, **cfg)
    for ix in (jx, tx):
        ix.build(db, ids)
    _same_table(jx, tx)
    assert tx.C % P == 0 and tx.Cp == tx.C // P and len(tx.data) == P
    assert all(t.shape == (tx.Cp, tx.M, D) for t in tx.data)
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    extra = clustered(rng, 200)
    for ix in (jx, tx):
        ix.add(extra, [f"s{i}" for i in range(200)])
        assert ix.delete(["v3", "s7", "nope"]) == 2
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    hits = tx.search(extra[:2], 3)
    assert hits[0][0][0] == "s0" and hits[1][0][0] == "s1"
    assert tx.fold_spill() == jx.fold_spill() == 199
    _same_table(jx, tx)
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    for ix in (jx, tx):
        ix.delete(["v10"])
        ix.add(db[10:11] * 0.99 + 0.01, ["v10"])  # nulls the stale table copy
    assert tx._ids_nulled and tx.ids.count(None) == jx.ids.count(None)
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    for ix in (jx, tx):
        ix.rebuild()
    _same_table(jx, tx)
    assert tx.count == 4096 + 200 - 2 and None not in tx._live and not tx._deleted
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    seen = {s for s, _ in tx.search(db[3], 3000)[0]}
    assert "v3" not in seen and "s7" not in seen
    assert tx.search(db[10:11] * 0.99 + 0.01, 1)[0][0][0] == "v10"


def test_batch_kernel_and_dense_scan_agree(mesh):
    """The batch-union scan's plain version (the port) and its Pallas
    kernel in interpret mode (memex_tpu) against the dense masked scan:
    top-1 equal and >= 6 of 8 shared (memex_tpu's bar: the slot banks),
    and the port's fused hits are memex_tpu's fused hits."""
    rng = np.random.default_rng(6)
    db = clustered(rng, 2048)
    ids = [f"v{i}" for i in range(2048)]
    qs = clustered(rng, 4)
    jx, fused = _pair(mesh, use_fused=True)
    dense = TorchSIVF(D, CPU8, n_clusters=16, nprobe=6, use_fused=False)
    for ix in (jx, fused, dense):
        ix.build(db, ids)
    a, b = dense.search(qs, 8), fused.search(qs, 8)
    for ha, hb in zip(a, b):
        assert ha[0][0] == hb[0][0]
        assert len({s for s, _ in ha} & {s for s, _ in hb}) >= 6
    same_hits(jx.search(qs, 8), b)


def test_exhaustive_probe_matches_flat_int8(mesh):
    """nprobe = C probes every cluster: the int8 flat scan's hits (same
    codes, same dot), within one id at the boundary."""
    rng = np.random.default_rng(7)
    db = clustered(rng, 2048)
    ids = [f"v{i}" for i in range(2048)]
    idx = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False)
    idx.build(db, ids)
    flat = TorchFlat(D, dtype="int8", use_fused=False, device="cpu")
    flat.add(db, ids)
    qs = clustered(rng, 6)
    for ha, hb in zip(idx.search(qs, 10), flat.search(qs, 10)):
        assert len({s for s, _ in ha} & {s for s, _ in hb}) >= 9


def test_build_device_matches_jax(mesh):
    """An int8 corpus built on the device (zero mean, padding rows past
    n_valid), with bucket overflow spilled and folded back."""
    rng = np.random.default_rng(8)
    db = clustered(rng, 3000, centers=3)
    from memex_tpu_torch.native_lib import np_quantize_rows_int8

    codes, scales = np_quantize_rows_int8(db)
    ids = [f"v{i}" for i in range(3000)] + [None] * 8
    codes = np.concatenate([codes, np.zeros((8, D), np.int8)])
    scales = np.concatenate([scales, np.zeros((8,), np.float32)])
    jx, tx = _pair(mesh, n_clusters=8, nprobe=3, bucket_factor=1.0)
    jx.build_device(jax.numpy.asarray(codes), jax.numpy.asarray(scales), ids, n_valid=3000)
    tx.build_device(torch.from_numpy(codes), torch.from_numpy(scales), ids, n_valid=3000)
    _same_table(jx, tx)
    assert not tx.mean.any() and tx._host_codes is None and tx.count == 3000
    assert tx.ids.count(None) == 8
    qs = clustered(rng, 5, centers=3)
    same_hits(jx.search(qs, 10), tx.search(qs, 10))
    with pytest.raises(ValueError, match="too small"):
        tx.build_device(torch.from_numpy(codes[:20]), torch.from_numpy(scales[:20]),
                        ids[:20])


def test_exact_fallback_flags_maintenance(mesh):
    """Deletes that crowd a query's probed buckets: the routed pass comes
    back short, and one exact pass over table and spill answers it; the
    index flags (never runs) the rebuild."""
    rng = np.random.default_rng(9)
    db = clustered(rng, 2048, centers=4)
    ids = [f"v{i}" for i in range(2048)]
    jx, tx = _pair(mesh, n_clusters=8, nprobe=1)
    for ix in (jx, tx):
        ix.build(db, ids)
        ix.add(clustered(rng, 30, centers=4), [f"s{i}" for i in range(30)])
    q = db[:1]
    top = [s for s, _ in tx.search(q, 2048)[0]]
    gone = top[:-3]  # all but three rows the one probed cluster holds
    for ix in (jx, tx):
        ix.delete(gone)
    assert not tx.maintenance_needed
    a, b = jx.search(q, 10), tx.search(q, 10)
    assert tx.maintenance_needed and jx.maintenance_needed
    same_hits(a, b)
    assert len(b[0]) == 10 and not {s for s, _ in b[0]} & set(gone)


def test_calibration_matches_jax(mesh):
    """calibrate_margin and calibrate_operating_point sample the same
    probe queries from the shards and choose the same operating point."""
    rng = np.random.default_rng(10)
    db = clustered(rng, 4096, centers=24, sigma=0.2)
    ids = [f"v{i}" for i in range(4096)]
    jx, tx = _pair(mesh, n_clusters=32, nprobe=4)
    for ix in (jx, tx):
        ix.build(db, ids)
    from memex_tpu.index.ivf import sample_corpus_queries as jax_sample
    from memex_tpu_torch.index.ivf import sample_corpus_queries

    np.testing.assert_allclose(sample_corpus_queries(tx, 16, seed=3),
                               jax_sample(jx, 16, seed=3), rtol=0, atol=1e-6)
    assert tx.calibrate_margin(target_overlap=0.9) == jx.calibrate_margin(target_overlap=0.9)
    assert tx.prune_margin == jx.prune_margin
    pt_t = tx.calibrate_operating_point(target_recall=0.95)
    pt_j = jx.calibrate_operating_point(target_recall=0.95)
    assert pt_t == pt_j and (tx.nprobe, tx.prune_margin) == (jx.nprobe, jx.prune_margin)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("refine", [False, True], ids=["int8", "refine"])
def test_checkpoint_interchange(mesh, tmp_path, refine, writer):
    """A `.ivfmesh` checkpoint written by either package (base, spill
    segments, a deleted id) restores in the other: the same centroids, no
    k-means rerun, and the same hits."""
    rng = np.random.default_rng(11)
    db = clustered(rng, 4096)
    ids = [f"v{i}" for i in range(4096)]
    jx, tx = _pair(mesh, refine=refine)
    src = jx if writer == "jax" else tx
    src.build(db, ids)
    src.add(clustered(rng, 64), [f"s{i}" for i in range(64)])
    src.delete(["v9", "s2"])
    path = str(tmp_path / "col.ivfmesh")
    src.save(path)
    if writer == "jax":
        dst = TorchSIVF(D, CPU8, n_clusters=16, nprobe=6, use_fused=False, refine=refine)
    else:
        dst = JaxSIVF(D, mesh, n_clusters=16, nprobe=6, use_fused=False, refine=refine)
    assert dst.restore(path) == src.count == 4096 + 64 - 2
    np.testing.assert_array_equal(np.asarray(dst.centroids), np.asarray(src.centroids))
    np.testing.assert_array_equal(np.asarray(dst.mean), np.asarray(src.mean))
    assert (dst.resid is not None) == refine
    qs = clustered(rng, 5)
    a, b = src.search(qs, 10), dst.search(qs, 10)
    same_hits(*((a, b) if writer == "jax" else (b, a)))
    assert "v9" not in {s for h in b for s, _ in h}


def test_incremental_checkpoint_keeps_the_base(tmp_path):
    """After the first save only the spill's new segment is written."""
    rng = np.random.default_rng(12)
    idx = TorchSIVF(D, CPU8, n_clusters=16, nprobe=6, use_fused=False)
    idx.build(clustered(rng, 2048), [f"v{i}" for i in range(2048)])
    path = str(tmp_path / "si")
    idx.save(path)
    base = open(path + ".npz", "rb").read()
    idx.add(clustered(rng, 30), [f"s{i}" for i in range(30)])
    idx.save(path)
    assert open(path + ".npz", "rb").read() == base
    smeta = json.load(open(path + ".spill.meta.json"))
    assert len(np.load(os.path.join(str(tmp_path), smeta["segments"][-1]))["ids"]) == 30


def test_fold_keeps_the_checkpoint_on_the_host(mesh, tmp_path):
    """A fold extends the host code shadow (no device gather at save), and
    the checkpoint restores in memex_tpu with the same hits."""
    rng = np.random.default_rng(13)
    db = clustered(rng, 2048)
    idx = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False, bucket_factor=4.0)
    idx.build(db, [f"v{i}" for i in range(2048)])
    assert idx.spill.count == 0
    idx.add(clustered(rng, 100), [f"s{i}" for i in range(100)])
    assert idx.fold_spill() == 100 and idx._host_codes is not None
    calls = []
    real = idx._gather
    idx._gather = lambda *a: calls.append(1) or real(*a)
    path = str(tmp_path / "fm")
    idx.save(path)
    assert not calls
    back = JaxSIVF(D, mesh, n_clusters=8, nprobe=8, use_fused=False)
    assert back.restore(path) == idx.count
    qs = clustered(rng, 4)
    same_hits(back.search(qs, 10), idx.search(qs, 10))


def _neartie(rng, n=4096, d=64):
    mu = rng.standard_normal(d).astype(np.float32)
    mu /= np.linalg.norm(mu)
    v = mu[None, :] + 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    qs = v[rng.choice(n, 32, replace=False)]
    return v, qs, np.argsort(-(qs @ v.T), axis=1)[:, :10]


def test_refine_lifts_recall_and_survives_restore_and_rebuild(mesh, tmp_path):
    """tests/test_sharded_ivf.py's near-tie corpus: plain int8 misranks,
    the per-shard float32 rescore restores the ranking with near-exact
    scores, through a save/restore and a rebuild, as memex_tpu's does."""
    rng = np.random.default_rng(5)
    v, qs, exact = _neartie(rng)
    ids = [f"v{i}" for i in range(len(v))]
    kw = dict(n_clusters=16, nprobe=16, use_fused=False)
    plain = TorchSIVF(64, CPU8, **kw)
    jx, refined = _pair(mesh, d=64, refine=True, **kw)
    for ix in (plain, jx, refined):
        ix.build(v, ids)
    assert refined.resid is not None and refined.rerank == 256
    r_plain = _recall(plain.search(qs, 10), exact)
    r_ref = _recall(refined.search(qs, 10), exact)
    assert r_plain < 0.9 and r_ref >= 0.97 and r_ref > r_plain + 0.1
    hits = refined.search(qs, 10)
    same_hits(jx.search(qs, 10), hits)
    err = max(abs(sc - float(qs[qi] @ v[int(sid[1:])])) for qi in range(8) for sid, sc in hits[qi])
    assert err < 2e-3
    path = str(tmp_path / "ck")
    refined.save(path)
    jfresh, fresh = _pair(mesh, d=64, refine=True, **kw)
    for ix in (jfresh, fresh):
        assert ix.restore(path) == len(v) and ix.resid is not None
    assert _recall(fresh.search(qs, 10), exact) >= 0.97
    same_hits(jfresh.search(qs, 10), fresh.search(qs, 10))
    # Residuals follow table rows through a rebuild; spill rows get zeros.
    extra = ["extra0", "extra1", "extra2", "extra3"]
    for ix in (jfresh, fresh):
        ix.add(v[:4] * 0.99 + 0.01, extra)
        ix.rebuild()
    assert fresh.resid is not None and _recall(fresh.search(qs, 10), exact) >= 0.95
    same_hits(jfresh.search(qs, 10), fresh.search(qs, 10))


def test_restore_ignores_the_saved_refine_and_rerank(mesh, tmp_path):
    """A reference fault the port keeps: restore() takes refine and rerank
    from the constructor, not from the checkpoint's meta (memex_tpu's
    ShardedIVFIndex.restore reads only `mean` of them)."""
    rng = np.random.default_rng(14)
    v = clustered(rng, 2048)
    src = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False, refine=True)
    src.build(v, [f"v{i}" for i in range(2048)])
    path = str(tmp_path / "r")
    src.save(path)
    meta = json.load(open(path + ".meta.json"))
    assert meta["refine"] is True and meta["rerank"] == 256
    for cls, where in ((TorchSIVF, CPU8), (JaxSIVF, mesh)):
        back = cls(D, where, n_clusters=8, nprobe=8, use_fused=False)
        assert back.restore(path) == 2048
        assert not back.refine and back.rerank is None and back.resid is None


def test_legacy_checkpoint_pins_zero_mean(mesh, tmp_path):
    """A checkpoint with no `mean` (raw codes) restores with mean = 0 in
    both packages, so later adds are not centered against a raw table."""
    rng = np.random.default_rng(15)
    v = clustered(rng, 2048)
    idx = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False, center=False)
    idx.build(v, [f"v{i}" for i in range(2048)])
    assert not idx.mean.any()
    path = str(tmp_path / "legacy")
    idx.save(path)
    meta = json.load(open(path + ".meta.json"))
    meta.pop("mean", None)
    json.dump(meta, open(path + ".meta.json", "w"))
    backs = [TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False),
             JaxSIVF(D, mesh, n_clusters=8, nprobe=8, use_fused=False)]
    backs[1].spill._interpret = True
    for back in backs:
        assert back.restore(path) == len(v)
        assert back.mean is not None and not back.mean.any()
        back.add(v[:2] * 0.995 + 0.001, ["x0", "x1"])
    hits = backs[0].search(v[:2], 3)
    assert all(score <= 1.01 for h in hits for _, score in h)  # no q . mean inflation
    same_hits(backs[1].search(v[:2], 3), hits)


def test_centered_checkpoint_roundtrip_scores(tmp_path):
    rng = np.random.default_rng(16)
    v = clustered(rng, 2048)
    idx = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False)
    idx.build(v, [f"v{i}" for i in range(2048)])
    assert idx.mean is not None and idx.mean.any()
    path = str(tmp_path / "centered")
    idx.save(path)
    back = TorchSIVF(D, CPU8, n_clusters=8, nprobe=8, use_fused=False)
    assert back.restore(path) == len(v)
    np.testing.assert_allclose(back.mean, idx.mean)
    a, b = idx.search(v[:4], 5), back.search(v[:4], 5)
    for qi in range(4):
        assert [s for s, _ in a[qi]] == [s for s, _ in b[qi]]
        np.testing.assert_allclose([x for _, x in a[qi]], [x for _, x in b[qi]], atol=1e-5)


def test_batch_kernel_shape_rule_names_the_shape():
    """Every shard takes the batch kernel when fused. memex_tpu's 100M
    geometry (C = 16384 over 8 shards, M = 7680, kk = 128) is in range; a
    bucket of more than 256 chunks raises with its shape rather than
    falling back to the dense scan."""
    idx = TorchSIVF(384, CPU8, n_clusters=16384, nprobe=64)
    assert idx.Cp == 2048
    idx._check_batch_shape(7680, 128, 4)
    with pytest.raises(ValueError, match=r"Cp=2048, M=300032, D=384\] with kk=128"):
        idx._check_batch_shape(300032, 128, 8)
    with pytest.raises(ValueError, match="kk=600"):
        idx._check_batch_shape(3072, 600, 4)


def test_shard_launches_read_nothing_back(monkeypatch):
    """Routing, the probe mask, the actives-first order, the refine rescore
    and the rowid gather of every shard read nothing back to the host (on
    cards, a read would hold the shards behind it): with every
    device->host read trapped around each shard's launches, all 8 shards
    run, and the first read is the merged result's. The batch kernel is
    stubbed: its plain version reads its walk length on the CPU."""
    rng = np.random.default_rng(17)
    db = clustered(rng, 2048)
    idx = TorchSIVF(D, CPU8, n_clusters=16, nprobe=6, use_fused=True, refine=True)
    idx.build(db, [f"v{i}" for i in range(2048)])
    launched, order = [], []

    def kernel(data, rscales, sizes, clist, nact, q, kk, banks):
        launched.append((clist.dtype, tuple(nact.shape), banks))
        z = torch.zeros((q.shape[0], kk), dtype=torch.int32)
        return torch.rand(q.shape[0], kk), z, z

    def trap(name):
        return lambda *a, **k: pytest.fail(f"host read in a shard's launches: {name}")

    real = idx._shard_candidates

    def trapped(p, *a):
        order.append(p)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "nonzero", "cpu", "numpy", "__int__", "__bool__",
                         "__float__"):
                m.setattr(torch.Tensor, name, trap(name))
            return real(p, *a)

    real_hits = idx._table_hits
    monkeypatch.setattr(tsivf, "ivf_batch_topk", kernel)
    monkeypatch.setattr(idx, "_shard_candidates", trapped)
    monkeypatch.setattr(idx, "_table_hits",
                        lambda v, o, m: order.append("merged") or real_hits(v, o, m))
    idx.search(db[:3], 5)
    assert order == [*range(P), "merged"]
    assert launched == [(torch.int32, (1,), 8)] * P


def _store_rows(n, seed=0, start=0):
    from memex_tpu_torch.store.base import VectorData

    rng = np.random.default_rng(seed)
    v = clustered(rng, n, centers=6, sigma=0.3)
    return [VectorData(id=f"r{start + i}", document_id=f"d{(start + i) // 3}", text="",
                       vector=v[i]) for i in range(n)]


def _same_store_hits(a, b):
    same_hits([[(h.id, h.score) for h in r] for r in a], [[(h.id, h.score) for h in r] for r in b])


def test_registry_builds_the_mesh_ivf_store(tmp_path):
    from memex_tpu_torch.store import registry
    from memex_tpu_torch.store.mesh_store import TpuMeshIVFStore

    store = registry.get_vector_storage(
        f"tpu+ivf+mesh://{tmp_path}/v?n_clusters=8&nprobe=2&refine=1&prune_target=0.9"
        "&bucket_factor=1.5&recall_target=0.95", "c", dim=D, device="cpu")
    assert isinstance(store, TpuMeshIVFStore)
    ix = store.index
    assert (ix.C, ix.nprobe, ix.refine, ix.rerank, ix.bucket_factor, ix.P) == \
        (8, 2, True, 256, 1.5, 1)
    assert store._prune_target == 0.9 and store._recall_target == 0.95 and store.count == 0


def test_store_matches_jax_through_inline_maintenance(mesh, tmp_path, monkeypatch):
    """Standalone stores (no scheduler), 8 shards each: a build, streaming
    adds past the spill rule (20% of > 4096 rows: folded in place), lazy
    calibration on the first search, delete churn past 25% (an inline
    rebuild), and a restart from the checkpoint."""
    from memex_tpu.store.tpu_store import TpuMeshIVFStore as JaxStore
    from memex_tpu_torch.store import mesh_store

    monkeypatch.setattr(mesh_store, "local_mesh", lambda device: [torch.device(device)] * P)
    kw = dict(n_clusters=8, nprobe=3, prune_target=0.9)
    js = JaxStore(str(tmp_path / "j"), "c", dim=D, **kw)
    ts = mesh_store.TpuMeshIVFStore(str(tmp_path / "t"), "c", dim=D, device="cpu", **kw)
    assert ts.index.P == P and not ts.index.use_fused
    rows = _store_rows(4200)
    for st in (js, ts):
        st.build(rows[:3000])
        for i in range(3000, 4200, 100):
            st.add_vectors(rows[i : i + 100])
    # Folded in place at 4,100 rows; the last batch waits in the spill.
    assert ts.index.spill.count == js.index.spill.count == 100
    assert ts.count == js.count == 4200
    q = np.stack([r.vector for r in rows[:7]])
    _same_store_hits(js.search_batch(q, 10), ts.search_batch(q, 10))
    assert ts.index.prune_margin == js.index.prune_margin and ts._calibrated
    gone = [f"r{i}" for i in range(0, 3600, 3)]  # 1200 tombstones > 25%: rebuild
    for st in (js, ts):
        assert st.delete(gone) == len(gone)
    assert not ts.index._deleted and ts.count == js.count == 3000 and not ts._calibrated
    _same_store_hits(js.search_batch(q, 10), ts.search_batch(q, 10))
    ts.checkpoint()
    back = mesh_store.TpuMeshIVFStore(str(tmp_path / "t"), "c", dim=D, device="cpu", **kw)
    assert back.count == 3000
    assert [h.id for h in back.search(q[1], 5)] == [h.id for h in ts.search(q[1], 5)]


def _runtime(tmp_path):
    from memex_tpu_torch.config import Settings
    from memex_tpu_torch.runtime import TorchRuntime

    s = Settings.from_env(db_uri=f"sqlite://{tmp_path}/t.db",
                          vector_uri=f"tpu+ivf+mesh://{tmp_path}/vec?n_clusters=4&nprobe=2")
    s.embedding_dim = D
    return TorchRuntime(s, device="cpu")


def _maintain_tasks(rt):
    from memex_tpu_torch.db import queue

    return [r["status"] for r in rt.db.query("SELECT status FROM queue WHERE task_type = ?",
                                             (queue.TaskType.Maintain.value,))]


def test_runtime_wires_maintenance_and_the_worker_trains(tmp_path):
    """Streaming adds past the spill rule with no table yet: the runtime
    queues one Maintain task (the index does not train inline), and the
    worker's run of the store's rebuild() trains the table."""
    from memex_tpu_torch.worker import Worker

    rt = _runtime(tmp_path)
    try:
        store = rt.store("c")
        assert store.on_maintenance == rt._enqueue_maintenance
        rows = _store_rows(4200, seed=2)
        for i in range(0, 4200, 300):
            store.add_vectors(rows[i : i + 300])
        assert _maintain_tasks(rt) == ["Queued"]
        assert store.index.data is None and store.index.spill.count == 4200
        assert Worker(rt, poll_interval=0.01).drain(timeout=120)
        assert _maintain_tasks(rt) == ["Completed"]
        assert store.index.data is not None and store.index.spill.count == 0
        hits = store.search_batch(np.stack([r.vector for r in rows[:4]]), 3)
        assert [h[0].id for h in hits] == [f"r{i}" for i in range(4)]
    finally:
        rt.search_batcher.close()


def test_search_shortfall_schedules_the_rebuild(tmp_path):
    """Deletes that leave a query's one probed cluster short: the exact
    fallback answers it, the store asks for maintenance once, and the
    worker's rebuild drops the tombstones."""
    from memex_tpu_torch.worker import Worker

    s_rt = _runtime(tmp_path)
    try:
        store = s_rt.store("c")
        store.index.nprobe = 1
        rows = _store_rows(600, seed=3)
        store.build(rows)
        q = np.stack([r.vector for r in rows[:1]])
        probed = [h.id for h in store.search_batch(q, 600)[0]]  # the probed cluster's rows
        gone = probed[:-3]
        assert len(gone) <= 256  # below the delete-churn rule
        store.delete(gone)
        assert _maintain_tasks(s_rt) == [] and not store.index.maintenance_needed
        hits = store.search_batch(q, 10)[0]
        assert len(hits) == 10 and not {h.id for h in hits} & set(gone)
        assert _maintain_tasks(s_rt) == ["Queued"] and not store.index.maintenance_needed
        assert Worker(s_rt, poll_interval=0.01).drain(timeout=120)
        assert not store.index._deleted and store.count == 600 - len(gone)
    finally:
        s_rt.search_batcher.close()


def test_batcher_warms_the_mesh_ivf_store_at_every_q_bucket(tmp_path, monkeypatch):
    from memex_tpu_torch.serve.query_path import _Q_BUCKETS, _bucket

    rt = _runtime(tmp_path)
    store = rt.store("c")
    try:
        assert rt.search_batcher.warmup("c") == 0  # empty: nothing to warm
        store.add_vectors(_store_rows(50))
        seen = []
        real = store.search_batch
        monkeypatch.setattr(store, "search_batch",
                            lambda v, k: seen.append(v.shape[0]) or real(v, k))
        n = rt.search_batcher.warmup("c")
        top = _bucket(rt.settings.search_max_batch, _Q_BUCKETS)
        assert seen == [b for b in _Q_BUCKETS if b <= top] and n == len(seen)
    finally:
        rt.search_batcher.close()
