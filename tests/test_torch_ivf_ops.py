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
