"""The port's ShardedFlatIndex (memex_tpu_torch/index/sharded.py) over 8
`cpu` shards against memex_tpu's over its 8 virtual devices
(tests/conftest.py), on the same numpy inputs: every storage tier with the
fused scans (memex_tpu's Pallas kernels in interpret mode, the port's
plain versions of K1-K4) and without; ingest's water-filled placement,
deletes, the tombstone-shortfall rerun, compaction, growth and clear;
the merge's tie order on rows duplicated across shards; checkpoints in
both directions; the shard-list helpers; and the `tpu+mesh://` store.

Tolerances: hit ids equal (where two scores sit within 2e-5 of each
other the ids may trade places); scores within 2e-5, float32 noise of the
same bf16-rounded or integer operands summed in another order."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from memex_tpu.index.sharded import ShardedFlatIndex as JaxSharded
from memex_tpu_torch.index.sharded import ShardedFlatIndex as TorchSharded
from memex_tpu_torch.parallel import local_mesh, merge_topk_across, replicate, row_blocks

torch.set_num_threads(2)

D, P = 32, 8
SCORE_ATOL = 2e-5
CPU8 = ["cpu"] * P


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < P:
        pytest.skip("needs memex_tpu's 8 virtual devices (tests/conftest.py)")
    return Mesh(np.array(jax.devices()[:P]), ("shard",))


def _unit(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(mesh, **kw):
    jx = JaxSharded(D, mesh, **kw)
    jx._interpret = True  # Pallas kernels in interpret mode on the CPU
    return jx, TorchSharded(D, CPU8, **kw)


def same_hits(a, b, atol=SCORE_ATOL):
    """memex_tpu's hits `a` and the port's `b`: scores within atol place by
    place, ids equal except where a near-tie (scores within 2 atol) lets
    two trade places."""
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


def _same_state(jx, tx):
    assert tx.counts == jx.counts and tx.cap == jx.cap and tx.dead == jx.dead
    assert tx.ids == jx.ids and tx.count == jx.count


TIERS = [
    dict(dtype="float32"),
    dict(dtype="bfloat16"),
    dict(dtype="int8"),
    dict(dtype="int8", query_quantize=False),
    dict(dtype="int4"),
]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("tier", TIERS, ids=lambda t: "-".join(map(str, t.values())))
def test_search_matches_jax(mesh, tier, fused):
    """Ingest in three batches (placement water-fills the shards), search,
    delete a query's best rows, re-add one: the same hits at every step."""
    rng = np.random.default_rng(0)
    v = _unit(rng, 1500)
    ids = [f"v{i}" for i in range(1500)]
    q = _unit(rng, 5) + 0.5 * v[:5]
    jx, tx = _pair(mesh, use_fused=fused, **tier)
    for lo, hi in ((0, 700), (700, 701), (701, 1500)):
        jx.add(v[lo:hi], ids[lo:hi])
        tx.add(v[lo:hi], ids[lo:hi])
    _same_state(jx, tx)
    same_hits(jx.search(q, 10), tx.search(q, 10))
    gone = [sid for sid, _ in jx.search(q[:1], 6)[0]] + ids[:50]
    assert tx.delete(gone) == jx.delete(gone) == 56
    _same_state(jx, tx)
    same_hits(jx.search(q, 10), tx.search(q, 10))
    for ix in (jx, tx):
        ix.add(v[:1], ["v0"])
    _same_state(jx, tx)
    same_hits(jx.search(q, 10), tx.search(q, 10))
    assert tx.rows_f32([5, 6]).shape == (2, D)
    np.testing.assert_array_equal(tx.rows_f32(sorted(tx.ids)), jx.rows_f32(sorted(jx.ids)))


def test_tombstone_shortfall_reruns_the_plain_scan(mesh):
    """140 of one query's best rows dead (memex_tpu's
    test_sharded_fused_recall_with_topk_deleted): both packages return the
    same 10 live hits. Tombstones are masked inside the scans, so a fused
    pass falls short only when its banks lose live rows; here the port's
    fused pass is made to drop its last candidate, and the index must rerun
    the plain scan, which masks tombstones before its top-k."""
    rng = np.random.default_rng(3)
    v = _unit(rng, 2048, 64)
    jx = JaxSharded(64, mesh, capacity_per_shard=512, dtype="int8", use_fused=True)
    jx._interpret = True
    tx = TorchSharded(64, CPU8, capacity_per_shard=512, dtype="int8", use_fused=True)
    ids = [f"v{i}" for i in range(2048)]
    q = _unit(rng, 1, 64)
    order = np.argsort(-(q @ v.T))[0]
    for ix in (jx, tx):
        ix.add(v, ids)
        ix.delete([f"v{r}" for r in order[:140]])
    want = jx.search(q, 10)
    same_hits(want, tx.search(q, 10))
    calls = []
    real = tx._search_shards

    def crowded(qq, k, fused):
        calls.append(fused)
        vals, idx = real(qq, k, fused)
        if fused:
            vals = vals.clone()
            vals[:, -1] = -1e30
        return vals, idx

    tx._search_shards = crowded
    hits = tx.search(q, 10)
    assert calls == [True, False]
    jx.use_fused = False  # memex_tpu's plain scan on the same index
    same_hits(jx.search(q, 10), hits)
    assert len(hits[0]) == 10 and not {int(s[1:]) for s, _ in hits[0]} & set(order[:140])
    tx.delete_all()  # no tombstones, no rerun: a short fused list stands
    tx.add(v[:20], ids[:20])
    calls.clear()
    assert len(tx.search(q, 10)[0]) == 9 and calls == [True]


def test_grow_compact_and_clear_match_jax(mesh):
    """Past capacity the shards double (a re-add that renumbers global
    rows); past 25% dead rows they compact; delete_all clears."""
    rng = np.random.default_rng(4)
    v = _unit(rng, 9000)
    ids = [f"g{i}" for i in range(9000)]
    jx, tx = _pair(mesh, dtype="int8", use_fused=True, capacity_per_shard=1024)
    for ix in (jx, tx):
        ix.add(v[:8000], ids[:8000])
        ix.delete(ids[:10])
        ix.add(v[8000:], ids[8000:])  # 9000 rows > 8 x 1024: grow to 2048
    _same_state(jx, tx)
    assert tx.cap == 2048 and tx.dead == 0 and tx._generation == jx._generation == 1
    q = v[100:104]
    same_hits(jx.search(q, 10), tx.search(q, 10))
    for ix in (jx, tx):
        ix.delete(ids[10:2500])  # > 25% dead: compact
    _same_state(jx, tx)
    assert tx.dead == 0 and sum(tx.counts) == 6500
    same_hits(jx.search(q, 10), tx.search(q, 10))
    for ix in (jx, tx):
        ix.delete_all()
    _same_state(jx, tx)
    assert tx.search(q, 3) == [[] for _ in range(4)]
    assert not any(a.any() for a in tx.alive)


def test_merge_prefers_the_lower_global_row():
    """Equal scores across shards: the merge keeps shard-major order, as
    lax.top_k over memex_tpu's all_gather does, against CUDA torch.topk's
    unspecified tie order."""
    rng = np.random.default_rng(5)
    vals = [torch.from_numpy(rng.integers(0, 3, (4, 6)).astype(np.float32)) for _ in range(P)]
    idx = [torch.arange(6, dtype=torch.int32).repeat(4, 1) + 100 * p for p in range(P)]
    mv, mi = merge_topk_across(vals, idx, 20, "cpu")
    all_v = np.concatenate([v.numpy() for v in vals], axis=1)
    all_i = np.concatenate([i.numpy() for i in idx], axis=1)
    ref_v, ref_o = jax.lax.top_k(all_v, 20)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(mi.numpy(), np.take_along_axis(all_i, np.asarray(ref_o), 1))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rows_duplicated_across_shards_tie_like_jax(mesh, dtype):
    """Sixteen copies of one row under different ids spread over every
    shard: equal scores, and both packages list the copies in global-row
    order."""
    rng = np.random.default_rng(6)
    v = _unit(rng, 400)
    v[::25] = v[0]  # 16 copies of row 0
    ids = [f"d{i}" for i in range(400)]
    jx, tx = _pair(mesh, dtype=dtype, use_fused=True)
    for ix in (jx, tx):
        ix.add(v, ids)
    a, b = jx.search(v[:1], 16), tx.search(v[:1], 16)
    assert [s for s, _ in a[0]] == [s for s, _ in b[0]]
    assert {s for s, _ in b[0]} == {f"d{i}" for i in range(0, 400, 25)}
    assert len({tx._id_to_row[s] // tx.cap for s, _ in b[0]}) == P  # on every shard
    assert [tx._id_to_row[s] for s, _ in b[0]] == sorted(tx._id_to_row[s] for s, _ in b[0])
    assert len({sc for _, sc in b[0]}) == 1


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
def test_checkpoint_interchange(mesh, tmp_path, dtype, writer):
    """A `.mesh` checkpoint written by either package (two incremental
    segments, a tombstone) restores in the other with the same rows, ids
    and hits."""
    rng = np.random.default_rng(7)
    v = _unit(rng, 900)
    ids = [f"c{i}" for i in range(900)]
    jx, tx = _pair(mesh, dtype=dtype, use_fused=False)
    src, dst_cls = (jx, TorchSharded) if writer == "jax" else (tx, JaxSharded)
    path = str(tmp_path / "col.mesh")
    src.add(v[:600], ids[:600])
    src.save(path)
    src.add(v[600:], ids[600:])
    src.delete(["c3", "c700"])
    src.save(path)
    assert len(src._segments) == 2
    dst = dst_cls(D, CPU8 if writer == "jax" else mesh, dtype=dtype, use_fused=False)
    assert dst.restore(path) == 898
    assert sorted(dst._id_to_row) == sorted(src._id_to_row)
    got = dict(zip((dst.ids[g] for g in sorted(dst.ids)), dst.rows_f32(sorted(dst.ids))))
    want = dict(zip((src.ids[g] for g in sorted(src.ids)), src.rows_f32(sorted(src.ids))))
    for sid, row in want.items():
        np.testing.assert_allclose(got[sid], row, rtol=0, atol=1e-6)
    q = v[10:14]
    same_hits(*((src.search(q, 10), dst.search(q, 10)) if writer == "jax"
                else (dst.search(q, 10), src.search(q, 10))))


def test_restore_does_not_resume_the_segment_log(tmp_path):
    """After a restore (global rows renumbered) the next save rewrites."""
    rng = np.random.default_rng(8)
    v = _unit(rng, 300)
    ix = TorchSharded(D, CPU8, use_fused=False)
    ix.add(v, [f"r{i}" for i in range(300)])
    path = str(tmp_path / "r.mesh")
    ix.save(path)
    back = TorchSharded(D, CPU8, use_fused=False)
    assert back.restore(path) == 300
    back.add(v[:2] * 0.5, ["x0", "x1"])
    back.save(path)
    assert len(back._segments) == 1  # one full rewrite, not an append
    again = TorchSharded(D, CPU8, use_fused=False)
    assert again.restore(path) == 302


def test_constructor_rounds_capacity_and_rejects_bad_input():
    ix = TorchSharded(D, ["cpu"] * 3, capacity_per_shard=1500)
    assert (ix.P, ix.cap, ix.use_fused) == (3, 2048, False)
    with pytest.raises(ValueError):
        TorchSharded(D, [], capacity_per_shard=1024)
    with pytest.raises(ValueError):
        TorchSharded(33, CPU8, dtype="int4")
    with pytest.raises(ValueError):
        TorchSharded(D, CPU8, dtype="int2")
    with pytest.raises(ValueError):
        ix.add(np.zeros((2, D + 1), np.float32), ["a", "b"])


def test_shard_list_helpers(monkeypatch):
    assert local_mesh("cpu") == [torch.device("cpu")]
    assert local_mesh("cpu", 8) == [torch.device("cpu")] * 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert local_mesh("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert local_mesh(torch.device("cuda", 1), 2) == [torch.device("cuda", i) for i in range(2)]
    t = torch.arange(12.0).reshape(6, 2)
    reps = replicate(t, ["cpu"] * 3)
    assert all(r is reps[0] for r in reps) and torch.equal(reps[0], t)
    blocks = row_blocks(t, [torch.device("cpu")] * 3)
    assert [b.shape for b in blocks] == [(2, 2)] * 3 and torch.equal(torch.cat(blocks), t)
    with pytest.raises(ValueError):
        row_blocks(t, [torch.device("cpu")] * 4)


def _store_rows(n, seed=0):
    from memex_tpu_torch.store.base import VectorData

    v = _unit(np.random.default_rng(seed), n)
    return [VectorData(id=f"m{i}", document_id=f"doc{i // 4}", text="", vector=v[i])
            for i in range(n)], v


def test_registry_builds_the_mesh_store_and_it_matches_jax(mesh, tmp_path, monkeypatch):
    """`tpu+mesh://` with memex_tpu's options, on 8 cpu shards (the runtime's
    cpu device gives one; the store is handed memex_tpu's 8 here), against
    memex_tpu's TpuMeshStore through ingest, delete and a restart."""
    from memex_tpu.store.tpu_store import TpuMeshStore as JaxMeshStore
    from memex_tpu_torch.store import mesh_store, registry

    monkeypatch.setattr(mesh_store, "local_mesh", lambda device: [torch.device(device)] * P)
    uri = f"tpu+mesh://{tmp_path}/t?dtype=int8&capacity_per_shard=1024&query_quantize=false"
    ts = registry.get_vector_storage(uri, "c", dim=D, device="cpu")
    assert isinstance(ts, mesh_store.TpuMeshStore)
    assert (ts.index.dtype, ts.index.cap, ts.index.query_quantize, ts.index.P) == \
        ("int8", 1024, False, P)
    js = JaxMeshStore(str(tmp_path / "j"), "c", dim=D, capacity_per_shard=1024, dtype="int8",
                      query_quantize=False)
    rows, v = _store_rows(700)
    for st in (js, ts):
        st.add_vectors(rows[:400])
        st.add_vectors(rows[400:])
        assert st.delete(["m1", "m2", "nope"]) == 2
    assert ts.count == js.count == 698
    res_j, res_t = js.search_batch(v[:5], 10), ts.search_batch(v[:5], 10)
    same_hits([[(h.id, h.score) for h in r] for r in res_j],
              [[(h.id, h.score) for h in r] for r in res_t])
    assert [h.document_id for h in res_t[0]] == [h.document_id for h in res_j[0]]
    ts.checkpoint()
    registry._REGISTRY.drop(uri, "c")
    back = registry.get_vector_storage(uri, "c", dim=D, device="cpu")
    assert back is not ts and back.count == 698
    assert [h.id for h in back.search(v[7], 3)] == [h.id for h in ts.search(v[7], 3)]
    back.delete_all()
    assert back.count == 0 and not (tmp_path / "t" / "c.mesh.meta.json").exists()


def test_sharded_ivf_draws_its_own_sample_like_the_ivf_index():
    """Left to its own torch draws (no memex_tpu draws handed in), the
    sharded IVF's device build is a function of its seed, and the same
    function as IVFIndex.build_device's: the same sample, centroids and
    buckets, cut into shards (no bucket overflows here)."""
    from memex_tpu_torch.index.ivf import IVFIndex
    from memex_tpu_torch.index.sharded_ivf import ShardedIVFIndex
    from memex_tpu_torch.ops.fused_topk import quantize_rows_int8

    rng = np.random.default_rng(9)
    topics = _unit(rng, 6)
    x = topics[rng.integers(0, 6, 3000)] + 0.3 * rng.standard_normal((3000, D)).astype(np.float32)
    codes, scales = quantize_rows_int8(torch.from_numpy(x / np.linalg.norm(x, axis=1)[:, None]))
    ids = [f"r{i}" for i in range(3000)]
    kw = dict(n_clusters=16, nprobe=4, bucket_factor=6.0, seed=3)
    one = IVFIndex(D, dtype="int8", device="cpu", **kw)
    one.build_device(codes, scales, ids)
    shards = [ShardedIVFIndex(D, ["cpu"] * 4, **kw) for _ in range(2)]
    for ix in shards:
        ix.build_device(codes, scales, ids)
    assert one.spill.count == shards[0].spill.count == 0
    assert torch.equal(shards[0].centroids, shards[1].centroids)
    assert torch.equal(shards[0].centroids, one.centroids)
    assert torch.equal(torch.cat(shards[0].data), one.data)
    assert torch.equal(torch.cat(shards[0].rscales), one.rscales)
    assert torch.equal(torch.cat(shards[0]._rowids_dev), one._rowids_dev)
    q = x[:5] / np.linalg.norm(x[:5], axis=1)[:, None]
    assert [h[0][0] for h in shards[0].search(q, 3)] == [h[0][0] for h in one.search(q, 3)]
