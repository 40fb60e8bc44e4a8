"""The port's IVF scan ops (memex_tpu_torch/ops/ivf_batch.py, ivf_batch4.py,
ivf_scan.py) against memex_tpu's on the CPU: routing and the chunk walk
exactly, K5, K6 and K7 (plain PyTorch versions; memex_tpu's Pallas kernels
in interpret mode) on ragged cluster sizes with empty active clusters, the
int4 packing bit for bit, and the int8 rerank.

Tolerances: scores agree within 1e-5 (the same bf16-rounded or float32
operands summed in a different order); an id may differ only at a
near-tie, where the port's row must score what the port reports."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.ops import ivf_batch as jb
from memex_tpu.ops import ivf_batch4 as jb4
from memex_tpu.ops import ivf_scan as js
from memex_tpu_torch.ops import ivf_batch as tb
from memex_tpu_torch.ops import ivf_batch4 as tb4
from memex_tpu_torch.ops import ivf_scan as ts

torch.set_num_threads(2)

C, M, D = 16, 1024, 32
SCORE_TOL = 1e-5


def _unit(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def table():
    """Ragged buckets: some empty, some full, some one row past a chunk."""
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, M + 1, C).astype(np.int32)
    sizes[[0, 5]] = 0
    sizes[3] = M
    sizes[7] = 513
    rows = _unit(rng, C * M).reshape(C, M, D)
    codes = rng.integers(-127, 128, (C, M, D)).astype(np.int8)
    rscales = (rng.random((C, M)).astype(np.float32) * 0.02 + 1e-3)
    centroids = _unit(rng, C)
    queries = _unit(rng, 5)
    return dict(sizes=sizes, rows=rows, codes=codes, rscales=rscales,
                centroids=centroids, queries=queries)


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(table, dtype):
    """(jax data, torch data, rscales) for a row dtype."""
    if dtype == "int8":
        return jnp.asarray(table["codes"]), _t(table["codes"]), table["rscales"]
    ones = np.ones((C, M), np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(table["rows"], jnp.bfloat16), _t(table["rows"]).bfloat16(), ones)
    return jnp.asarray(table["rows"]), _t(table["rows"]), ones


def _check_hits(jv, jc, js_, tv, tc, ts_, score_of):
    """Values within SCORE_TOL position by position; (cluster, slot) equal
    except at near-ties, where the port's row must score its value."""
    jv, jc, js_ = (np.asarray(x) for x in (jv, jc, js_))
    tv, tc, ts_ = (x.numpy() for x in (tv, tc, ts_))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=SCORE_TOL)
    live = jv > -1e29
    diff = live & ((tc != jc) | (ts_ != js_))
    for qi, pos in zip(*np.nonzero(diff)):
        assert abs(score_of(qi, tc[qi, pos], ts_[qi, pos]) - tv[qi, pos]) <= SCORE_TOL
    assert diff.sum() <= max(2, live.sum() // 50), "ids differ beyond near-ties"


def _score_fn(table, dtype, exact, queries):
    """The kernels' arithmetic for one (query, cluster, slot), in float64."""
    rows = table["codes"].astype(np.float64) if dtype == "int8" else table["rows"]
    q = queries
    if not (exact and dtype == "float32"):
        q = np.asarray(torch.from_numpy(queries).bfloat16().float())
        if dtype != "int8":
            rows = np.asarray(torch.from_numpy(np.asarray(rows, np.float32)).bfloat16().float())
    scale = table["rscales"] if dtype == "int8" else np.ones((C, M), np.float32)
    return lambda qi, c, s: float(np.dot(q[qi].astype(np.float64),
                                         np.asarray(rows[c, s], np.float64)) * scale[c, s])


@pytest.mark.parametrize("margin", [None, 0.3])
def test_route_union_and_chunk_walk_equal(table, margin):
    jl, jn = jb.route_union(jnp.asarray(table["centroids"]), jnp.asarray(table["queries"]), 6,
                            prune_margin=margin)
    tl, tn = tb.route_union(_t(table["centroids"]), _t(table["queries"]), 6,
                            prune_margin=margin)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for S in (256, 512, 1024):
        jw, jc = jb._chunk_walk(jnp.asarray(table["sizes"]), jl, jn, M, S)
        tw, tc = tb._chunk_walk(_t(table["sizes"]), tl, tn, M, S)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_route_union_zero_query_probes_the_first_clusters(table):
    """A zero pad row ties every centroid: it adds clusters 0..nprobe-1."""
    cl, n = tb.route_union(_t(table["centroids"]), torch.zeros((1, D)), 4)
    assert int(n[0]) == 4 and cl[:4].tolist() == [0, 1, 2, 3]


def test_chunk_walk_refuses_more_than_256_chunks(table):
    with pytest.raises(ValueError, match="256"):
        tb._chunk_walk(_t(table["sizes"]), torch.arange(C, dtype=torch.int32),
                       torch.tensor([C], dtype=torch.int32), 257 * 128, 128)


@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("dtype,exact", [("float32", False), ("float32", True),
                                         ("bfloat16", False), ("int8", False)])
def test_k5_plain_matches_jax(table, dtype, exact, keep2):
    jd, td, rsc = _data(table, dtype)
    q = table["queries"]
    jl, jn = jb.route_union(jnp.asarray(table["centroids"]), jnp.asarray(q), 6)
    tl, tn = tb.route_union(_t(table["centroids"]), _t(q), 6)
    k = 256
    ref = jb.ivf_batch_topk(jd, jnp.asarray(rsc), jnp.asarray(table["sizes"]), jl, jn,
                            jnp.asarray(q), k, banks=4, interpret=True, exact=exact,
                            keep2=keep2)
    got = tb.ivf_batch_topk(td, _t(rsc), _t(table["sizes"]), tl, tn, _t(q), k, banks=4,
                            exact=exact, keep2=keep2)
    _check_hits(*ref, *got, _score_fn(table, dtype, exact, q))


def test_pack_int4_bit_equal(table):
    codes = table["codes"]
    for banks in (4, 8):
        j4, jr = jb4.pack_int4_buckets(jnp.asarray(codes), jnp.asarray(table["rscales"]),
                                       c_blk=5, banks=banks)
        t4, tr = tb4.pack_int4_buckets(_t(codes), _t(table["rscales"]), c_blk=5, banks=banks)
        np.testing.assert_array_equal(t4.numpy(), np.asarray(j4))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("keep2", [False, True])
def test_k6_and_rerank_match_jax(table, keep2):
    q = table["queries"]
    j4, jr4 = jb4.pack_int4_buckets(jnp.asarray(table["codes"]), jnp.asarray(table["rscales"]))
    t4, tr4 = tb4.pack_int4_buckets(_t(table["codes"]), _t(table["rscales"]))
    jl, jn = jb.route_union(jnp.asarray(table["centroids"]), jnp.asarray(q), 6)
    tl, tn = tb.route_union(_t(table["centroids"]), _t(q), 6)
    r = 200
    ref = jb4.ivf_batch_topk4(j4, jr4, jnp.asarray(table["sizes"]), jl, jn, jnp.asarray(q), r,
                              interpret=True, keep2=keep2)
    got = tb4.ivf_batch_topk4(t4, tr4, _t(table["sizes"]), tl, tn, _t(q), r, keep2=keep2)
    q16 = np.asarray(torch.from_numpy(q).bfloat16().float(), np.float64)
    hi4 = np.clip((table["codes"].astype(np.int64) + 8) >> 4, -7, 7)

    def score4(qi, c, s):  # the int4 code of row s, times rscales4
        return float(q16[qi] @ hi4[c, s] * table["rscales"][c, s] * 16.0)

    _check_hits(*ref, *got, score4)
    jv, jc, jsl = jb4.rerank_int8(jnp.asarray(table["codes"]), jnp.asarray(table["rscales"]),
                                  jnp.asarray(q), *ref, 10)
    tv, tc, tsl = tb4.rerank_int8(_t(table["codes"]), _t(table["rscales"]), _t(q),
                                  _t(np.asarray(ref[0])), _t(np.asarray(ref[1])),
                                  _t(np.asarray(ref[2])), 10)
    _check_hits(jv, jc, jsl, tv, tc, tsl, _score_fn(table, "int8", False, q))


@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("banks", [4, 8])
@pytest.mark.parametrize("size", [1, 100, 256, 257, 512, 515])
def test_k6_matches_jax_where_a_cluster_ends_inside_a_chunk(table, size, banks, keep2):
    """K6 at both chunk widths (S = 512, 1024: a block of the CUDA kernel
    owns 4 slot pairs, and S / 2 is a multiple of 4 for either), with a
    probed cluster whose size ends on the chunk's first row, inside its
    first half (every second row of a pair dead, and first rows too), on
    the half's edge, and inside its second half."""
    sizes = table["sizes"].copy()
    sizes[2] = size
    q = table["queries"]
    j4, jr4 = jb4.pack_int4_buckets(jnp.asarray(table["codes"]), jnp.asarray(table["rscales"]),
                                    banks=banks)
    t4, tr4 = tb4.pack_int4_buckets(_t(table["codes"]), _t(table["rscales"]), banks=banks)
    # Every cluster is active: cluster 2 is in the union whatever the routing.
    clist, nact = np.arange(C, dtype=np.int32), np.array([C], np.int32)
    r = 200
    ref = jb4.ivf_batch_topk4(j4, jr4, jnp.asarray(sizes), jnp.asarray(clist),
                              jnp.asarray(nact), jnp.asarray(q), r, banks=banks,
                              interpret=True, keep2=keep2)
    got = tb4.ivf_batch_topk4(t4, tr4, _t(sizes), _t(clist), _t(nact), _t(q), r, banks=banks,
                              keep2=keep2)
    q16 = np.asarray(torch.from_numpy(q).bfloat16().float(), np.float64)
    hi4 = np.clip((table["codes"].astype(np.int64) + 8) >> 4, -7, 7)

    def score4(qi, c, s):
        return float(q16[qi] @ hi4[c, s] * table["rscales"][c, s] * 16.0)

    _check_hits(*ref, *got, score4)
    tv, tc, tsl = (x.numpy() for x in got)
    assert (tsl < sizes[tc])[tv > -1e29].all()  # no row past its cluster's size
    assert ((tc == 2) & (tv > -1e29)).sum() <= size * len(q)


def test_ivf_batch_search4_rerank_depth(table, monkeypatch):
    """ivf_batch_search4 hands the rerank min(max(rerank * k, 64), S), with
    S the bank width (doubled under keep2)."""
    t4, tr4 = tb4.pack_int4_buckets(_t(table["codes"]), _t(table["rscales"]))
    seen = []
    real = tb4.ivf_batch_topk4

    def spy(*args, **kw):
        seen.append(args[6])
        return real(*args, **kw)

    monkeypatch.setattr(tb4, "ivf_batch_topk4", spy)
    args = (_t(table["centroids"]), t4, tr4, _t(table["codes"]), _t(table["rscales"]),
            _t(table["sizes"]), _t(table["queries"]), 6, 10)
    tb4.ivf_batch_search4(*args)
    tb4.ivf_batch_search4(*args, rerank=3)
    tb4.ivf_batch_search4(*args, rerank=200, keep2=True)
    assert seen == [512, 64, 1024]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k7_plain_matches_jax(table, dtype):
    jd, td, rsc = _data(table, dtype)
    q = table["queries"]
    qc = q @ table["centroids"].T
    probes = np.argsort(-qc, axis=1, kind="stable")[:, :5].astype(np.int32)
    ref = js.ivf_probe_topk(jd, jnp.asarray(rsc), jnp.asarray(table["sizes"]),
                            jnp.asarray(probes), jnp.asarray(q), 128, interpret=True)
    got = ts.ivf_probe_topk(td, _t(rsc), _t(table["sizes"]), _t(probes), _t(q), 128)
    _check_hits(*ref, *got, _score_fn(table, dtype, False, q))


# -- K7's probe-shared walk: the work list, the split folds and their merge --


@pytest.mark.parametrize("Q,nprobe,n_clusters", [(1, 4, 4), (5, 3, 6), (32, 4, 4),
                                                 (77, 8, 16), (128, 16, 1000)])
def test_k7_work_list_holds_every_pair_once_grouped_by_cluster(Q, nprobe, n_clusters):
    rng = np.random.default_rng(Q)
    qc = rng.standard_normal((Q, n_clusters)).astype(np.float32)
    probes = torch.from_numpy(np.argsort(-qc, axis=1, kind="stable")[:, :nprobe].astype(np.int32))
    S = 256
    T, n_tiles, R = ts.probe_plan(Q, nprobe, n_clusters, 4 * S, S)
    assert T in ts.TILE_Q and 1 <= R <= 4
    pairs, tiles = ts.probe_work_list(probes, n_clusters, T, n_tiles)
    again = ts.probe_work_list(probes, n_clusters, T, n_tiles)
    assert torch.equal(pairs, again[0]) and torch.equal(tiles, again[1])
    e = pairs.numpy().astype(np.int64)
    assert sorted(e.tolist()) == list(range(Q * nprobe))  # every (q, rank) pair once
    cid = probes.numpy().reshape(-1)[e]
    # Grouped by cluster, ascending; within a cluster, pairs in their own order.
    assert (np.diff(cid) >= 0).all()
    assert all((np.diff(e[cid == c]) > 0).all() for c in np.unique(cid))
    t_cid, t_off, t_nq = (x.numpy() for x in tiles)
    live = t_nq > 0
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()  # the list, then nothing
    assert (t_cid[n_live:] == Q * nprobe).all() and (t_off[n_live:] == Q * nprobe).all()
    assert (t_nq <= T).all()
    # The tiles cut the grouped pairs in order, each within one cluster.
    assert np.array_equal(t_off[:n_live], np.concatenate([[0], np.cumsum(t_nq[:n_live])[:-1]]))
    assert int(t_nq.sum()) == Q * nprobe
    for c, off, nq in zip(t_cid[:n_live], t_off[:n_live], t_nq[:n_live]):
        assert (cid[off : off + nq] == c).all()
    # A cluster's tiles are full but its last.
    for c in np.unique(cid):
        nqs = t_nq[:n_live][t_cid[:n_live] == c]
        assert (nqs[:-1] == T).all() and nqs.sum() == (cid == c).sum()


@pytest.mark.parametrize("Q", [1, 32, 128])
def test_k7_plan_cuts_long_buckets_into_ranges_and_short_ones_across_slots(Q):
    """The 1M-row, 4-cluster index (1,232 chunks a bucket), K7's regime:
    R > 1 ranges, so that its fewest tiles fill about TARGET_BLOCKS blocks
    of one slot group each (32 across S = 256); the 10M index (12 chunks a
    bucket, off K7's path), whose tiles alone fill the card: one range,
    with the slots still one group a block."""
    T, n_tiles, R = ts.probe_plan(Q, 4, 4, 315392, 256)
    assert T == max(16, Q) and n_tiles >= 4 and R > 1
    assert 4 * R * 32 >= ts.TARGET_BLOCKS > 4 * (R - 1) * 32
    T, n_tiles, R = ts.probe_plan(Q, 64, 4096, 3072, 256)
    fewest = max(Q * 64 // 16, 64)  # tiles the list has at least
    assert T == 16 and R == 1 and n_tiles >= fewest
    # float32 rows: 4 slots a block, 64 blocks across the slots.
    R = ts.probe_plan(Q, 4, 4, 315392, 256, block_slots=4)[2]
    assert 4 * R * 64 >= ts.TARGET_BLOCKS > 4 * (R - 1) * 64


@pytest.mark.parametrize("ranges", [1, 2, 3, 5])
def test_k7_chunk_ranges_cover_each_bucket_in_order(ranges):
    S = 256
    sizes = torch.tensor([0, 1, 255, 256, 257, 700, 1024], dtype=torch.int32)
    g0, g1 = ts.chunk_ranges(sizes, S, ranges)
    live = (sizes.long() + S - 1) // S
    assert (g0[:, 0] == 0).all() and torch.equal(g1[:, -1], live)
    assert torch.equal(g1[:, :-1], g0[:, 1:]) and (g1 >= g0).all()


def _tie_table(dtype, M=1024, S=256):
    """Exact ties by construction: integer rows and queries (exact dots in
    any order), one scale for every int8 row, clusters 1, 3 and 4 copies of
    cluster 0 (ties across probes) and every chunk of a bucket a copy of its
    first (ties across chunks, so across ranges). Cluster 2 is empty,
    clusters 3 and 4 end mid-chunk."""
    rng = np.random.default_rng(11)
    n_c = 5
    chunk = rng.integers(-8, 9, (n_c, S, D))
    rows = np.tile(chunk, (1, M // S, 1))
    rows[[1, 3, 4]] = rows[0]
    sizes = np.array([M, M, 0, 300, 700], np.int32)
    q = rng.integers(-3, 4, (6, D)).astype(np.float32)
    if dtype == "int8":
        data = torch.from_numpy(rows.astype(np.int8))
    else:
        data = torch.from_numpy(rows.astype(np.float32)).to(getattr(torch, dtype))
    rscales = torch.full((n_c, M), 0.01 if dtype == "int8" else 1.0)
    # Every query probes every cluster, in its own order; 0 before 1 for
    # some, 1 before 0 for others.
    probes = np.stack([rng.permutation(n_c) for _ in range(len(q))]).astype(np.int32)
    return data, rscales, torch.from_numpy(sizes), torch.from_numpy(probes), torch.from_numpy(q)


@pytest.mark.parametrize("ranges", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k7_merge_of_split_partials_is_the_one_pass_fold(dtype, ranges):
    """The kernel's split: partial banks per (query, rank, range), merged in
    (rank, range) order with strict '>', give the one-pass fold of
    ivf_probe_bank_reference bit for bit, values and indices, on a table
    whose slots tie exactly across two probes and across ranges."""
    data, rscales, sizes, probes, q = _tie_table(dtype)
    part_v, part_i = ts.ivf_probe_partials_reference(data, rscales, sizes, probes, q, ranges)
    assert part_v.shape == (6, 5 * ranges, 256)
    (mv,), (mi,) = ts.ivf_probe_merge_reference(part_v, part_i)
    (rv,), (ri,) = ts.ivf_probe_bank_reference(data, rscales, sizes, probes, q)
    assert torch.equal(mv, rv) and torch.equal(mi, ri)
    # The ties are real: every winning value recurs in another partial bank.
    assert ((part_v == mv[:, None, :]).sum(dim=1) >= 2).all()
    # An empty cluster's partial banks are all (-1e30, 0).
    empty = (probes == 2).nonzero()
    for qi, p in empty.tolist():
        blk = slice(p * ranges, (p + 1) * ranges)
        assert (part_v[qi, blk] == ts.NEG_INF).all() and (part_i[qi, blk] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k7_plain_matches_jax_few_clusters(dtype):
    """K7's real regime: few clusters, each probed by every query."""
    rng = np.random.default_rng(7)
    n_c, m = 2, 1024
    sizes = np.array([m, 700], np.int32)
    rows = _unit(rng, n_c * m).reshape(n_c, m, D)
    codes = rng.integers(-127, 128, (n_c, m, D)).astype(np.int8)
    rsc = rng.random((n_c, m)).astype(np.float32) * 0.02 + 1e-3
    q = _unit(rng, 5)
    probes = np.argsort(-(q @ _unit(rng, n_c).T), axis=1, kind="stable").astype(np.int32)
    if dtype == "int8":
        jd, td = jnp.asarray(codes), _t(codes)
    else:
        rsc = np.ones((n_c, m), np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jd, td = jnp.asarray(rows, jdt), _t(rows).to(getattr(torch, dtype))
    ref = js.ivf_probe_topk(jd, jnp.asarray(rsc), jnp.asarray(sizes), jnp.asarray(probes),
                            jnp.asarray(q), 128, interpret=True)
    got = ts.ivf_probe_topk(td, _t(rsc), _t(sizes), _t(probes), _t(q), 128)
    table = dict(rows=rows, codes=codes, rscales=rsc)
    _check_hits(*ref, *got, _score_fn(table, dtype, False, q))
