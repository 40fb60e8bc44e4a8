"""The port's IVFIndex (memex_tpu_torch/index/ivf.py) against memex_tpu's on
the CPU: k-means from a shared initialisation, search on every tier and
option (the fused branches: memex_tpu's Pallas kernels in interpret mode,
the port's plain versions of K5-K7), the spill, delete and re-add,
fold_spill, both rebuilds, the calibrations, and checkpoints loaded in
both directions.

jax.random's draws are not torch's, so each test feeds the port
memex_tpu's k-means initialisation (`kmeans_fit(init=...)`).

Tolerances: ids equal; scores within 1e-5 (the same bf16-rounded or float32
operands summed in a different order, plus the host-side q . mean)."""

import jax
import numpy as np
import pytest
import torch

import memex_tpu_torch.index.ivf as tivf
from memex_tpu.index.ivf import IVFIndex as JaxIVF
from memex_tpu.index.ivf import _nprobe_ladder as jax_ladder
from memex_tpu.index.ivf import kmeans_assign as jax_assign
from memex_tpu.index.ivf import kmeans_fit as jax_fit
from memex_tpu.index.ivf import sample_corpus_queries as jax_sample
from memex_tpu_torch.index.ivf import IVFIndex as TorchIVF

torch.set_num_threads(2)

D, C = 32, 16
_FIT = tivf.kmeans_fit
SCORE_ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    """Clustered rows (8 topics) and queries near them."""
    rng = np.random.default_rng(0)
    topics = _unit(rng.standard_normal((8, D)))
    db = _unit(topics[rng.integers(0, 8, 2400)] + 0.3 * rng.standard_normal((2400, D)))
    qs = _unit(topics[rng.integers(0, 8, 9)] + 0.3 * rng.standard_normal((9, D)))
    return db, qs, [f"v{i}" for i in range(len(db))]


def _jax_init(n, n_clusters, seed):
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,),
                                      replace=n < n_clusters))


@pytest.fixture
def shared_init(monkeypatch):
    """The port's k-means starts from memex_tpu's initial rows."""
    def with_jax_init(vectors, n_clusters, iters=10, seed=0, **kw):
        init = torch.from_numpy(_jax_init(vectors.shape[0], n_clusters, seed))
        return _FIT(vectors, n_clusters, iters, seed, init=init)

    monkeypatch.setattr(tivf, "kmeans_fit", with_jax_init)


def _pair(**kw):
    kw.setdefault("n_clusters", C)
    kw.setdefault("nprobe", 4)
    kw.setdefault("use_fused", True)
    jx = JaxIVF(D, **kw)
    jx._interpret = True  # Pallas kernels in interpret mode on the CPU
    return jx, TorchIVF(D, device="cpu", **kw)


def _same_hits(a, b):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert [sid for sid, _ in ha] == [sid for sid, _ in hb]
        np.testing.assert_allclose([s for _, s in ha], [s for _, s in hb], rtol=0,
                                   atol=SCORE_ATOL)


def test_kmeans_from_a_shared_init():
    rng = np.random.default_rng(1)
    x = _unit(rng.standard_normal((3000, D)))
    ref = np.array(jax_fit(x, 24, seed=3))
    got = tivf.kmeans_fit(torch.from_numpy(x), 24, seed=3,
                          init=torch.from_numpy(_jax_init(3000, 24, 3)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tivf.kmeans_assign(torch.from_numpy(x), got).numpy(),
                                  np.asarray(jax_assign(x, ref)))
    # Centroids as init, and torch's own draw: unit centroids either way.
    again = tivf.kmeans_fit(torch.from_numpy(x), 24, iters=0, init=torch.from_numpy(ref))
    np.testing.assert_array_equal(again.numpy(), ref)
    own = tivf.kmeans_fit(torch.from_numpy(x), 24, generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(own.norm(dim=1).numpy(), 1.0, atol=1e-5)


CONFIGS = [
    dict(dtype="float32"),
    dict(dtype="float32", use_fused=False),
    dict(dtype="bfloat16"),
    dict(dtype="bfloat16", use_fused=False),
    dict(dtype="int8"),
    dict(dtype="int8", use_fused=False),
    dict(dtype="int8", refine=True),
    dict(dtype="int8", scan_int4=True),
    dict(dtype="int8", prune_margin=0.2),
    dict(dtype="float32", scan_precision="highest"),
    dict(dtype="float32", rerank=32),
    dict(dtype="int8", center=False),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_search_matches_jax(cfg, corpus, shared_init):
    """Build, stream a spill, delete, re-add: the same hits at every step."""
    db, qs, ids = corpus
    jx, tx = _pair(**cfg)
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
        ix.add(db[2000:], ids[2000:])
    np.testing.assert_allclose(tx.centroids.numpy(), np.asarray(jx.centroids), atol=1e-5)
    np.testing.assert_array_equal(tx.sizes.numpy(), np.asarray(jx.sizes))
    np.testing.assert_array_equal(tx.rowids, jx.rowids)
    np.testing.assert_array_equal(tx.mean, jx.mean)
    assert tx.count == jx.count and tx.spill.count == jx.spill.count
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))
    top = [h[0][0] for h in tx.search(qs, 10)]
    for ix in (jx, tx):
        assert ix.delete(top[:3] + ["v2300", "nope"]) == 4
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))
    for ix in (jx, tx):  # re-adding a deleted table id un-deletes it from the spill
        ix.add(db[[int(s[1:]) for s in top[:2]]], top[:2])
    assert tx._ids_nulled == jx._ids_nulled and tx.ids == jx.ids
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))


def test_spill_only_index_below_the_clustering_floor(corpus):
    db, qs, ids = corpus
    jx, tx = _pair(dtype="int8")
    for ix in (jx, tx):
        ix.build(db[:40], ids[:40])
    assert tx.data is None and tx.spill.count == 40
    _same_hits(jx.search(qs, 5), tx.search(qs, 5))


def test_fold_spill_and_rebuild_match_jax(corpus, shared_init):
    """fold_spill places spill rows exactly as memex_tpu does (host-built
    int8 table with a centered code space); the host rebuild retrains."""
    db, qs, ids = corpus
    jx, tx = _pair(dtype="int8", bucket_factor=1.0)
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
        ix.add(db[2000:], ids[2000:])
        ix.delete(["v5", "v2100"])
    assert tx.fold_spill() == jx.fold_spill() > 0
    np.testing.assert_array_equal(tx.sizes.numpy(), np.asarray(jx.sizes))
    np.testing.assert_array_equal(tx.rowids, jx.rowids)
    np.testing.assert_array_equal(tx._rowids_dev.numpy(), np.asarray(jx._rowids_dev))
    np.testing.assert_array_equal(tx._host_data, jx._host_data)
    assert tx.ids == jx.ids and tx.spill.ids == jx.spill.ids
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))
    for ix in (jx, tx):
        ix.rebuild()  # centered: the host path
    assert tx.spill.count == jx.spill.count and not tx._deleted
    np.testing.assert_array_equal(tx.sizes.numpy(), np.asarray(jx.sizes))
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))


def test_refine_fold_carries_the_residual_store(corpus, shared_init):
    db, qs, ids = corpus
    jx, tx = _pair(dtype="int8", refine=True, bucket_factor=1.0)
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
        ix.add(db[2000:], ids[2000:])
        ix.fold_spill()
    np.testing.assert_array_equal(tx.resid.numpy(), np.asarray(jx.resid))
    np.testing.assert_array_equal(tx._host_resid, jx._host_resid)
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))


def _device_init(monkeypatch, codes, scales, n_valid, seed=0):
    """memex_tpu's build_device draws a sample and then k-means' initial
    rows with jax.random; hand the port the same initial centroids."""
    m = min(n_valid, max(C * 64, 65536))
    perm = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n_valid, (m,), replace=False))
    rows = perm[_jax_init(m, C, seed)]
    init = torch.from_numpy(codes[rows].astype(np.float32) * scales[rows][:, None])
    monkeypatch.setattr(tivf, "kmeans_fit", lambda v, n_c, iters=10, seed=0, **kw:
                        _FIT(v, n_c, iters, seed, init=init))


def test_build_device_fold_and_rebuild_device_match_jax(corpus, monkeypatch):
    """The all-device build (overflow spilled then folded), and the device
    rebuild after deletes and streamed rows."""
    from memex_tpu.native_lib import np_quantize_rows_int8

    db, qs, ids = corpus
    codes, scales = np_quantize_rows_int8(db)
    jx, tx = _pair(dtype="int8", bucket_factor=1.0)
    _device_init(monkeypatch, codes, scales, 2000)
    jx.build_device(jax.numpy.asarray(codes[:2000]), jax.numpy.asarray(scales[:2000]),
                    ids[:2000])
    tx.build_device(torch.from_numpy(codes[:2000]), torch.from_numpy(scales[:2000]), ids[:2000])
    assert tx.rowids is None and tx._host_data is None
    np.testing.assert_array_equal(tx.sizes.numpy(), np.asarray(jx.sizes))
    np.testing.assert_array_equal(tx._rowids_dev.numpy(), np.asarray(jx._rowids_dev))
    np.testing.assert_array_equal(tx.data.numpy(), np.asarray(jx.data))
    assert tx.spill.count == jx.spill.count
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))
    for ix in (jx, tx):
        ix.add(db[2000:], ids[2000:])
        ix.delete(["v1", "v2", "v2001"])
    live = jx._live_cluster_mask()
    n_live = int(live.sum()) + int((np.asarray(jx.spill.alive)[: jx.spill.count] > 0).sum())
    # The compacted corpus the rebuild trains on: live table rows, then spill.
    jt = np.asarray(jx.data).reshape(-1, D)[np.nonzero(live.reshape(-1))[0]]
    js = np.asarray(jx.rscales).reshape(-1)[np.nonzero(live.reshape(-1))[0]]
    alive = np.asarray(jx.spill.alive)[: jx.spill.count] > 0
    sc = np.asarray(jx.spill.buf)[: jx.spill.count][alive]
    ss = np.asarray(jx.spill.scales)[: jx.spill.count][alive]
    _device_init(monkeypatch, np.concatenate([jt, sc]), np.concatenate([js, ss]), n_live)
    for ix in (jx, tx):
        ix.rebuild()
    assert not tx._deleted and tx.count == jx.count
    np.testing.assert_array_equal(tx.sizes.numpy(), np.asarray(jx.sizes))
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))


def test_probe_scan_serves_buckets_the_batch_scan_cannot(corpus, monkeypatch):
    """More than 256 chunks of 1024 rows in a bucket: search takes the
    per-query probe scan (K7's plain version on the CPU)."""
    db, qs, ids = corpus
    tx = TorchIVF(D, n_clusters=2, nprobe=2, bucket_factor=600.0, use_fused=True, device="cpu")
    tx.build(db[:1000], ids[:1000])
    assert tx.data.shape[1] // 1024 > 256
    calls = []
    real = tivf.ivf_probe_topk
    monkeypatch.setattr(tivf, "ivf_probe_topk", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    hits = tx.search(db[:4], 5)
    assert calls and [h[0][0] for h in hits] == ids[:4]


def test_probe_scan_function_matches_jax(corpus, shared_init):
    """_ivf_search_fused (routing + K7) on a table both packages route alike."""
    from memex_tpu.index.ivf import _ivf_search_fused as jax_fused

    db, qs, ids = corpus
    jx, tx = _pair(dtype="int8")
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
    ref = jax_fused(jx.centroids, jx.data, jx.rscales, jx.sizes, qs, 4, 50, interpret=True)
    got = tivf._ivf_search_fused(tx.centroids, tx.data, tx.rscales, tx.sizes,
                                 torch.from_numpy(qs), 4, 50)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_calibrations_match_jax(corpus, shared_init):
    db, qs, ids = corpus
    assert tivf._nprobe_ladder(3, 16) == jax_ladder(3, 16) == [3, 6, 12, 16]
    jx, tx = _pair(dtype="int8", nprobe=2)
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
    np.testing.assert_allclose(tivf.sample_corpus_queries(tx, 16, seed=2),
                               jax_sample(jx, 16, seed=2), rtol=0, atol=1e-6)
    for target in (0.9, 0.99):
        assert tx.calibrate_margin(target_overlap=target, n_queries=16) == \
            jx.calibrate_margin(target_overlap=target, n_queries=16)
        assert tx.calibrate_margin(target_overlap=target, n_queries=16,
                                   target_metric="recall") == \
            jx.calibrate_margin(target_overlap=target, n_queries=16, target_metric="recall")
    for ix in (jx, tx):
        ix.nprobe, ix.prune_margin = 2, None
    assert tx.calibrate_operating_point(target_recall=0.97, n_queries=16) == \
        jx.calibrate_operating_point(target_recall=0.97, n_queries=16)
    assert (tx.nprobe, tx.prune_margin) == (jx.nprobe, jx.prune_margin)
    empty = TorchIVF(D, device="cpu")
    assert empty.calibrate_margin() is None and empty.calibrate_operating_point() is None


@pytest.mark.parametrize("cfg", [dict(dtype="float32"), dict(dtype="bfloat16"),
                                 dict(dtype="int8"), dict(dtype="int8", refine=True)],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_checkpoints_interchange(cfg, corpus, shared_init, tmp_path):
    """memex_tpu's checkpoint loads into the port and the port's into
    memex_tpu, with deletes and a spill; both then search alike."""
    db, qs, ids = corpus
    jx, tx = _pair(**cfg)
    for ix in (jx, tx):
        ix.build(db[:2000], ids[:2000])
        ix.add(db[2000:], ids[2000:])
        ix.delete(["v3", "v2200"])
    jx.save(str(tmp_path / "j"))
    tx.save(str(tmp_path / "t"))
    j_npz, t_npz = np.load(str(tmp_path / "j.npz")), np.load(str(tmp_path / "t.npz"))
    assert sorted(t_npz.files) == sorted(j_npz.files)
    for a in j_npz.files:
        np.testing.assert_allclose(t_npz[a], j_npz[a], rtol=0, atol=1e-6) \
            if a == "centroids" else np.testing.assert_array_equal(t_npz[a], j_npz[a])
    # A load repacks the buckets (deleted rows dropped), so each package's
    # load of one file is compared with the other's load of the same file.
    for path in ("j", "t"):
        back_j = JaxIVF.load(str(tmp_path / path), use_fused=True)
        back_j._interpret = True
        back_t = TorchIVF.load(str(tmp_path / path), device="cpu", use_fused=True)
        assert back_t.count == back_j.count == jx.count and back_t.refine == jx.refine
        np.testing.assert_array_equal(back_t.mean, back_j.mean)
        _same_hits(back_j.search(qs, 10), back_t.search(qs, 10))


def test_device_built_base_is_skipped_and_flags_recovery(corpus, tmp_path, monkeypatch):
    from memex_tpu.native_lib import np_quantize_rows_int8

    db, qs, ids = corpus
    codes, scales = np_quantize_rows_int8(db[:2000])
    tx = TorchIVF(D, n_clusters=C, dtype="int8", device="cpu")
    tx.build_device(torch.from_numpy(codes), torch.from_numpy(scales), ids[:2000])
    tx.add(db[2000:2010], ids[2000:2010])
    tx.save(str(tmp_path / "d"))
    assert TorchIVF.exists(str(tmp_path / "d")) and JaxIVF.exists(str(tmp_path / "d"))
    for back in (TorchIVF.load(str(tmp_path / "d"), device="cpu"),
                 JaxIVF.load(str(tmp_path / "d"))):
        assert back.needs_recovery and back.data is None
    monkeypatch.setenv("MEMEX_CKPT_DEVICE_BASE", "1")
    tx.save(str(tmp_path / "f"))
    back = TorchIVF.load(str(tmp_path / "f"), device="cpu", use_fused=True)
    back_j = JaxIVF.load(str(tmp_path / "f"), use_fused=True)
    back_j._interpret = True
    assert not back.needs_recovery and back.count == back_j.count == tx.count
    _same_hits(back_j.search(qs, 10), back.search(qs, 10))


def test_ivf_state_from_numpy_installs_a_jax_table(corpus):
    db, qs, ids = corpus
    jx = JaxIVF(D, n_clusters=C, nprobe=4, dtype="int8", refine=True, use_fused=True)
    jx._interpret = True
    jx.build(db[:2000], ids[:2000])
    tx = TorchIVF(D, n_clusters=C, nprobe=4, dtype="int8", refine=True, use_fused=True,
                  device="cpu")
    tivf.ivf_state_from_numpy(tx, centroids=jx.centroids, data=jx.data, rscales=jx.rscales,
                              sizes=jx.sizes, rowids=jx.rowids, ids=jx.ids, mean=jx.mean,
                              resid=jx.resid, resid_scales=jx.resid_scales)
    assert tx.count == 2000
    _same_hits(jx.search(qs, 10), tx.search(qs, 10))


def test_constructor_rejects_what_memex_tpu_asserts():
    for kw in (dict(dtype="int4"), dict(scan_int4=True), dict(refine=True),
               dict(dtype="int8", scan_precision="highest"), dict(scan_precision="x")):
        with pytest.raises(ValueError):
            TorchIVF(D, device="cpu", **kw)
    ix = TorchIVF(D, device="cpu", dtype="float32")
    with pytest.raises(ValueError, match="int8"):
        ix.build_device(torch.zeros((100, D), dtype=torch.int8), torch.ones(100),
                        [str(i) for i in range(100)])
    assert TorchIVF(D, device="cpu", dtype="int8", refine=True).rerank == 256
    assert not TorchIVF(D, device="cpu").use_fused
