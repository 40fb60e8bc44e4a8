"""The port's benchmark entry point (memex_tpu_torch/bench.py) against
memex_tpu's root bench.py, on the CPU.

- The Reporter cases are tests/test_bench_report.py's on the port; its
  compact line is held to memex_tpu's on the same tier results and stage
  dicts (equal: the compact line carries no roofline field).
- `quantize_rows_int4` is bit-equal to memex_tpu's jitted quantizer
  through a transpose (memex_tpu packs [D/2, N], the port [N, D/2]).
- bench_kernels' tier functions meet memex_tpu's ops called with
  bench.py's arguments (Pallas in interpret mode) on the same 8,192 x 384
  rows: the exact f32 tier's ids are equal; every other tier's top-10
  overlaps memex_tpu's by at least KERNEL_OVERLAP = 0.98 a query on
  average (the float kernels sum their products in another order, so a
  near-tie may fall either way).
- Every other stage runs once at a small size and returns the keys that
  bench.py's stage returns (listed below from its source).
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from memex_tpu.index.flat import _search_rerank_fused as j_search_rerank_fused
from memex_tpu.ops import fused_topk as jft
from memex_tpu_torch import bench
from memex_tpu_torch.ops import fused_topk as tft

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
KERNEL_N = 8192
KERNEL_OVERLAP = 0.98


def _fake_results(roofline):
    return {
        "f32": {"qps": 15000.0, "p50_batch_ms": 2.1, "recall_at_10": 0.99,
                "query_batch": 32, "roofline": roofline("f32", 32, 32 / 15000.0)},
        "int8q_q512": {"qps": 372000.0, "p50_batch_ms": 1.4,
                       "recall_at_10": 0.969, "query_batch": 512,
                       "roofline": roofline("int8q_q512", 512, 512 / 372000.0)},
        "bad": {"qps": 9e9, "p50_batch_ms": 0.01, "recall_at_10": 0.5,
                "query_batch": 32, "roofline": {}},
    }


# -- the Reporter (tests/test_bench_report.py's cases) ---------------------------------


def test_reporter_emits_parseable_full_line(capsys):
    rep = bench.Reporter()
    rep.emit()  # parseable before any tier ran
    rep.set_headline(_fake_results(bench._roofline))
    rep.doc["e2e"]["scale_10M"] = {"n": 1}
    rep.emit()
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln]
    assert len(lines) == 4  # each emit: the full document, then the compact line
    first, full, last = json.loads(lines[0]), json.loads(lines[-2]), json.loads(lines[-1])
    assert first["value"] == 0.0 and first["metric"]
    # The headline is the fastest tier clearing the recall bar.
    for doc in (full, last):
        assert doc["storage_tier"] == "int8q_q512"
        assert doc["value"] == 372000.0
        assert doc["vs_baseline"] == 37.2
    assert full["e2e"]["scale_10M"] == {"n": 1}
    assert len(lines[-1]) < 1500


def test_roofline_fields_at_the_h100_peaks():
    """By hand: 372k QPS at Q = 512 is 1.3763 ms a batch over 1,048,576
    rows x 388 B = 295.6 GB/s (8.8% of 3,350 GB/s) and 2 x 1,048,576 x 384
    x 512 operations = 299.57 TOP/s (15.1% of int8's 1,979): compute
    bound. The f32 tier at 15k QPS, Q = 32: 1,536 B a row, 755.0 GB/s
    (22.5%), 12.08 TFLOP/s of float32's 67 (18.0%): bytes bound."""
    r = bench._roofline("int8q_q512", 512, 512 / 372000.0)
    assert r == {"achieved_tops": 299.57, "hbm_gbps": 295.6, "pct_peak_hbm": 8.8,
                 "pct_peak_compute": 15.1, "bound": "compute"}
    assert bench._roofline("f32", 32, 32 / 15000.0) == {
        "achieved_tops": 12.08, "hbm_gbps": 755.0, "pct_peak_hbm": 22.5,
        "pct_peak_compute": 18.0, "bound": "hbm"}
    # int4 reads half the bytes a row.
    assert (bench._roofline("int4", 32, 1e-3)["hbm_gbps"]
            < bench._roofline("int8q", 32, 1e-3)["hbm_gbps"])
    assert bench._roofline("unknown", 32, 1e-3) == {}


def test_reporter_recall_regression_still_emits():
    rep = bench.Reporter()
    rep.set_headline({"only": {"qps": 100.0, "p50_batch_ms": 1.0,
                               "recall_at_10": 0.2, "query_batch": 32}})
    assert rep.doc["storage_tier"] == "only"
    assert rep.doc["recall_at_10_vs_exact"] == 0.2


def test_full_doc_sidecar_and_compact_telemetry(monkeypatch, tmp_path, capsys):
    doc_path = tmp_path / "BENCH_FULL.json"
    monkeypatch.setenv("MEMEX_BENCH_DOC_PATH", str(doc_path))
    rep = bench.Reporter()
    rep.set_headline(_fake_results(bench._roofline))
    rep.doc["e2e"]["llm_decode"] = {
        "stream_tok_per_s": 270.0, "batch_tok_per_s": 290.0, "first_token_ms": 120.5}
    rep.doc["e2e"]["ivf_prune_realtext"] = {
        "encode_windows_per_s": 2500.0,
        "encode_roofline": {"bound": "fetch", "pct_peak_mxu": 22.0}}
    rep.emit()
    lines = capsys.readouterr().out.strip().splitlines()
    compact = json.loads(lines[-1])
    assert compact["llm_stream_ratio"] == round(270.0 / 290.0, 3)
    assert compact["llm_first_token_ms"] == 120.5
    assert compact["encode_windows_per_s"] == 2500.0
    assert compact["encode_bound"] == "fetch"
    assert len(lines[-1]) < 1500
    sidecar = json.loads(doc_path.read_text())
    assert sidecar["storage_tier"] == "int8q_q512"
    assert sidecar["e2e"]["llm_decode"]["batch_tok_per_s"] == 290.0


def test_emit_without_doc_path_writes_nothing(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("MEMEX_BENCH_DOC_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    bench.Reporter().emit()
    capsys.readouterr()
    assert list(tmp_path.iterdir()) == []


def test_stage_error_surfaces_in_compact_line(capsys):
    rep = bench.Reporter()
    rep.set_headline(_fake_results(bench._roofline))

    def boom():
        raise RuntimeError("use-after-free: buffer was released")

    bench._stage_guard(rep.doc["e2e"], "llm_decode", boom)
    rep.doc["e2e"]["scale_10M"] = {
        "ivf_pruned": {"ivf_int4_pruned_error": "kernel launch failed"}}
    c = rep.compact()
    assert c["errors"] == 2
    assert c["error_stages"] == ["ivf_int4_pruned", "llm_decode"]
    keys = list(c.keys())
    assert keys.index("errors") < keys.index("skipped_stages")
    assert "use-after-free" in rep.doc["e2e"]["llm_decode_error"]


def _stage_dicts() -> dict:
    return {
        "scale_10M": {
            "ivf_nprobe64_qps_q32": 7106.2, "ivf_recall_at_10_vs_exact_f32": 0.9594,
            "ivf_pruned": {"floor_met": False,
                           "best_at_95": {"margin": 0.5, "qps_q32": 8311.8,
                                          "recall_at_10": 0.9594},
                           "sweep": [{"ivf_int4_pruned_error": ""}]},
            "ivf_refine_qps_q32": 5000.0, "ivf_refine_recall_at_10_vs_exact_f32": 0.98,
            "ivf_refine_tie_recall_at_10": 0.97, "ivf_refine_pruned_qps_q32": 6000.0,
            "ivf_refine_pruned_qps_q128": 9000.0,
            "ivf_refine_pruned_recall_at_10_vs_exact_f32": 0.975,
        },
        "recall_vs_hnsw": {"exact_tiers_beat_hnsw": True, "int8q_beats_hnsw": False},
        "llm_decode": {"stream_tok_per_s": 283.4, "batch_tok_per_s": 291.2,
                       "first_token_ms": 133.9},
        "ivf_prune_realtext": {"float32": {"recall_at_10_vs_exact_f32": 0.9984},
                               "int8": {"recall_at_10_vs_exact_f32": 0.7344},
                               "encode_windows_per_s": 2170.9,
                               "encode_roofline": {"bound": "device"}},
        "serve_1M": {"qps": 3794.0, "p50_ms": 31.8, "qps_vs_capability": 1.143},
        "sharded_ivf_1M": {"refine_error": "out of memory"},
    }


@pytest.mark.parametrize("with_stages", [False, True])
def test_compact_line_equals_memex_tpus(with_stages):
    """The same tier results (each package's roofline) and stage dicts give
    memex_tpu's compact line, key for key and value for value, and the
    same headline fields; the tiers' rows differ only in the roofline."""
    reps = []
    for mod in (jbench, bench):
        rep = mod.Reporter()
        rep.set_headline(_fake_results(mod._roofline))
        if with_stages:
            rep.doc["e2e"].update(_stage_dicts())
            rep.doc["e2e"]["query_p50_ms"] = 12.5
            rep.doc["skipped_stages"].append({"stage": "llm_decode", "why": "env"})
        rep.doc["backend"] = "cuda"
        rep.doc["elapsed_s"] = 123.4
        reps.append(rep)
    j, t = reps
    assert list(t.compact().items()) == list(j.compact().items())
    roof = {"achieved_tops", "hbm_gbps", "pct_peak_hbm", "pct_peak_compute", "bound"}
    for name, row in j.doc["tiers"].items():
        assert {k: v for k, v in t.doc["tiers"][name].items() if k not in roof} == \
            {k: v for k, v in row.items() if k not in roof}
    for key in ("value", "vs_baseline", "storage_tier", "recall_at_10_vs_exact",
                "p50_batch_ms", "query_batch"):
        assert t.doc[key] == j.doc[key]


# -- the int4 quantizer ------------------------------------------------------------------


@pytest.mark.parametrize("n, d", [(1000, 384), (257, 64)])
def test_quantize_rows_int4_is_memex_tpus_jitted_quantizer(n, d):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:n // 2] /= np.linalg.norm(x[:n // 2], axis=1, keepdims=True)
    x[3] = 0.0          # the 1e-12 floor
    x[4] *= 1e-14       # below it
    x[5, :] = 7.0 / 2   # exact half steps: round half to even
    x[6] = np.linspace(-1, 1, d)
    codes, scales = tft.quantize_rows_int4(torch.from_numpy(x))
    j_codes, j_scales = jax.jit(jft.quantize_rows_int4)(jnp.asarray(x))
    assert codes.dtype == torch.int8 and codes.shape == (n, d // 2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes).T)
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  np.asarray(j_scales).view(np.uint32))
    # The host packer of the ingest path agrees on the codes' layout.
    h_codes, _ = tft.np_quantize_rows_int4(x[:8])
    assert h_codes.shape == (8, d // 2)


def test_quantize_rows_int4_refuses_an_odd_dim():
    with pytest.raises(ValueError):
        tft.quantize_rows_int4(torch.zeros((2, 3)))


# -- bench_kernels -------------------------------------------------------------------


def _jax_tiers(db: np.ndarray):
    """memex_tpu's tier functions from bench.py:355-384 (and :340-348 for
    the refine tiers) on the same rows, Pallas in interpret mode. block_n
    (the TPU kernels' row tile) is capped at the rows present: N must be a
    multiple of it there, and it does not change a result (every tile
    folds its columns in ascending order)."""
    n = db.shape[0]
    dbj = jnp.asarray(db)
    db16 = dbj.astype(jnp.bfloat16)
    db8, scales, rq8, rsc2 = jft.quantize_rows_int8_refine(dbj)
    db4t, _ = jax.jit(jft.quantize_rows_int4)(dbj)

    def bn(b):
        return min(b, n)

    def int8q(block_n):
        return lambda q: jft.fused_score_topk_int8q(db8, scales, q, 10, count=n,
                                                    block_n=bn(block_n), banks=4,
                                                    interpret=True)

    def int4(deferred):
        return lambda q: jft.fused_score_topk_int4_rerank(
            db4t, scales, db8, q, 10, count=n, rerank=64, block_n=bn(32768),
            deferred=deferred, interpret=True)

    return {
        "f32": lambda q: jft.fused_score_topk(dbj, q, 10, count=n, block_n=bn(2048),
                                              exact=True, keep2=True, interpret=True),
        "bf16": lambda q: jft.fused_score_topk(db16, q, 10, count=n, block_n=bn(1024),
                                               interpret=True),
        "int8": lambda q: jft.fused_score_topk_int8(db8, scales, q, 10, count=n,
                                                    block_n=bn(1024), interpret=True),
        "int8q": int8q(8192),
        "int4": int4(True),
        "int8q_refine": lambda q: j_search_rerank_fused(
            db8, scales, None, rq8, rsc2, None, n, q, 10, 64, 64, bn(8192), True, False,
            "int8", True, False),
        "int4_refine": lambda q: j_search_rerank_fused(
            db4t, scales, db8, rq8, rsc2, None, n, q, 10, 64, 128, bn(32768), True, True,
            "int4", True, False),
        "int8q_q128": int8q(32768),
        "int8q_q256": int8q(32768),
        "int8q_q512": int8q(16384),
        "int4_q128": int4(False),
    }


@pytest.fixture(scope="module")
def kernel_case():
    db = bench.kernel_rows("cpu", KERNEL_N).numpy()
    q = np.random.default_rng(7).standard_normal((32, 384)).astype(np.float32)
    port = {name: fn for name, _, fn in bench.kernel_tiers(torch.from_numpy(db))}
    return port, _jax_tiers(db), q


TIERS = ["f32", "bf16", "int8", "int8q", "int4", "int8q_refine", "int4_refine",
         "int8q_q128", "int8q_q256", "int8q_q512", "int4_q128"]


@pytest.mark.parametrize("tier", TIERS)
def test_kernel_tier_matches_memex_tpus_ops(kernel_case, tier):
    port, jax_fns, q = kernel_case
    got = port[tier](torch.from_numpy(q))[1].numpy()
    ref = np.asarray(jax_fns[tier](jnp.asarray(q))[1])
    assert got.shape == ref.shape == (32, 10)
    if tier == "f32":
        np.testing.assert_array_equal(got, ref)
    else:
        overlap = np.mean([len(set(g) & set(r)) / 10 for g, r in zip(got, ref)])
        assert overlap >= KERNEL_OVERLAP, (tier, overlap)


def test_bench_kernels_runs_every_tier_with_bench_py_keys():
    ticks = []
    res = bench.bench_kernels("cpu", on_tier=lambda r: ticks.append(len(r)), n=KERNEL_N,
                              chain=2, chain_big=2, reps=1)
    assert list(res) == TIERS
    assert ticks == list(range(1, len(TIERS) + 1))
    for name, row in res.items():
        assert set(row) == {"qps", "p50_batch_ms", "recall_at_10", "query_batch", "roofline"}
        assert row["roofline"] == {}  # no device figure from a CPU run
        assert row["qps"] > 0
        # PERF.md section 2's bars: 0.95 flat, 0.99 for the refine tiers.
        assert row["recall_at_10"] >= (0.99 if "refine" in name else 0.95), (name, row)
    assert res["f32"]["recall_at_10"] == 1.0
    assert res["int8q_q512"]["query_batch"] == 512


# -- the other stages, small -----------------------------------------------------------

# bench.py:963-990.
SCALE_10M_KEYS = {
    "n", "corpus_gen_s", "flat_int8q_q128_qps", "flat_roofline", "ivf_build_device_s",
    "ivf_spill_rows", "ivf_nprobe64_qps_q32", "ivf_nprobe64_qps_q128", "ivf_p50_batch_ms",
    "ivf_p50_batch_ms_q128", "ivf_roofline_q32", "ivf_roofline_q128",
    "oracle_exact_f32_scan_s", "ivf_recall_at_10_vs_int8_exact",
    "ivf_recall_at_10_vs_exact_f32", "ivf_tie_recall_at_10_vs_exact_f32", "ivf_pruned",
    "ivf_refine_fill_s", "ivf_refine_qps_q32", "ivf_refine_recall_at_10_vs_exact_f32",
    "ivf_refine_tie_recall_at_10", "ivf_refine_rerank", "ivf_refine_pruned_margin",
    "ivf_refine_pruned_qps_q32", "ivf_refine_pruned_qps_q128",
    "ivf_refine_pruned_recall_at_10_vs_exact_f32", "ivf_refine_pruned_tie_recall_at_10",
    "ivf_int4_pack_s", "ivf_int4_qps_q32", "ivf_int4_qps_q128",
    "ivf_int4_recall_at_10_vs_exact_f32", "ivf_int4_pruned_qps_q32",
    "ivf_int4_pruned_margin", "ivf_int4_pruned_recall_at_10_vs_exact_f32",
    "ckpt_incremental_s", "rebuild_device_s", "spill_after_rebuild"}
PRUNED_KEYS = {"union_clusters_full", "sweep", "selection_floor", "floor_met", "best_at_95",
               "qps_q128_at_best95"}  # bench.py:748-769
SWEEP_KEYS = {"margin", "qps_q32", "recall_at_10", "tie_recall_at_10", "union_clusters"}
SHARDED_KEYS = {"n", "mesh_devices", "build_device_s", "qps_q32",
                "recall_at_10_vs_int8_exact", "calibrated_margin", "refine"}  # :1066-1099
SHARDED_REFINE_KEYS = {"build_s", "qps_q32_e2e", "recall_at_10_vs_exact_f32"}  # :1151
HNSW_KEYS = {"n", "corpus_gen_s", "hnsw", "tiers", "exact_tiers_beat_hnsw",
             "int8q_beats_hnsw"}  # :1219-1244
LLM_KEYS = {"geometry", "params_m", "param_dtype", "prompt_len", "max_new", "compile_s",
            "batch_tok_per_s", "prefill_ms", "stream_tok_per_s", "first_token_ms",
            "backend"}  # llm_bench's line, as BENCH_FULL.json records it
E2E_KEYS = {"ingest_docs_per_s", "query_p50_ms", "query_p99_ms", "query_concurrent_qps",
            "query_store_rows"}  # :1654-1660
SERVE_KEYS = {"rows", "load_1M_s", "warmup_s", "warmed_executables", "concurrent_clients",
              "qps", "p50_ms", "p99_ms", "device_capability_qps", "qps_vs_capability",
              "batches", "mean_batch_fill", "dispatch_mean_ms", "complete_mean_ms",
              "http_clients", "http_qps"}  # :1793-1806, :1767-1777, :1895


def test_scale_10m_small_returns_bench_py_keys():
    out = bench.bench_scale_10m("cpu", n10=16384, blk=4096, centers=64, n_clusters=16,
                                nprobe=4, batches=2, reps=1, n_extra=64)
    assert set(out) == SCALE_10M_KEYS, set(out) ^ SCALE_10M_KEYS
    assert set(out["ivf_pruned"]) == PRUNED_KEYS
    assert all(set(p) == SWEEP_KEYS for p in out["ivf_pruned"]["sweep"])
    assert out["n"] == 16384
    assert out["flat_roofline"] == {} and out["ivf_roofline_q32"] == {}
    # A returned oracle row scores its oracle value exactly: tie-aware
    # recall is never below id recall against the float32 oracle.
    assert out["ivf_tie_recall_at_10_vs_exact_f32"] >= out["ivf_recall_at_10_vs_exact_f32"]
    assert out["ivf_recall_at_10_vs_exact_f32"] >= 0.9
    assert out["ivf_refine_recall_at_10_vs_exact_f32"] >= out["ivf_recall_at_10_vs_exact_f32"]
    assert out["spill_after_rebuild"] == 0


def test_scale_10m_reads_its_rows_from_the_env(monkeypatch):
    """MEMEX_BENCH_10M_BLOCKS sets n in units of 1,048,576 rows; this run
    stops at the first device step by asking for too many clusters."""
    monkeypatch.setenv("MEMEX_BENCH_10M_BLOCKS", "0")
    with pytest.raises(ValueError, match="too small"):
        bench.bench_scale_10m("cpu", blk=4096, centers=8, n_clusters=16, batches=1, reps=1)


def test_scale_10m_raises_when_block_0_regenerates_other_bits(monkeypatch):
    """The float32 oracle re-draws each block from its seed: a stage whose
    re-draw of block 0 differs raises (main records it as scale_10M_error)
    before it indexes anything."""
    monkeypatch.setattr(torch, "equal", lambda a, b: False)
    with pytest.raises(RuntimeError, match="regenerated"):
        bench.bench_scale_10m("cpu", n10=16384, blk=4096, centers=64, n_clusters=16,
                              nprobe=4, batches=1, reps=1, n_extra=64)


def test_sharded_ivf_small_returns_bench_py_keys():
    out = bench.bench_sharded_ivf("cpu", n1=16384, centers=64, clusters_per_device=16,
                                  nprobe=4, batches=2, reps=1, refine_rows=4096,
                                  refine_clusters=16, refine_nprobe=8)
    assert SHARDED_KEYS <= set(out) <= SHARDED_KEYS | {"qps_q32_pruned", "recall_at_10_pruned"}
    assert out["mesh_devices"] == 1
    assert set(out["refine"]) == {"plain", "refine"}
    assert all(set(r) == SHARDED_REFINE_KEYS for r in out["refine"].values())
    assert out["recall_at_10_vs_int8_exact"] >= 0.9
    assert (out["refine"]["refine"]["recall_at_10_vs_exact_f32"]
            >= out["refine"]["plain"]["recall_at_10_vs_exact_f32"])


def test_recall_vs_hnsw_small_returns_bench_py_keys(monkeypatch, tmp_path):
    monkeypatch.delenv("MEMEX_BENCH_BUILD_HNSW", raising=False)
    kw = dict(n1=4096, qn=16, n_clusters=16, nprobe=4, cache_dir=str(tmp_path))
    assert set(bench.bench_recall_vs_hnsw("cpu", **kw)) == {"skipped"}  # no graph cached
    monkeypatch.setenv("MEMEX_BENCH_BUILD_HNSW", "1")
    out = bench.bench_recall_vs_hnsw("cpu", **kw)
    assert set(out) == HNSW_KEYS
    assert set(out["tiers"]) == {"f32_flat", "int8q_flat", "ivf_int8_pruned"}
    assert isinstance(out["hnsw"]["build_s"], float)
    again = bench.bench_recall_vs_hnsw("cpu", **kw)  # the cached graph
    assert again["hnsw"]["build_s"] == "cached"
    assert again["hnsw"]["recall_at_10_vs_exact"] == out["hnsw"]["recall_at_10_vs_exact"]


def test_llm_small_returns_llm_bench_keys():
    out = bench.bench_llm("cpu", geometry="tiny", prompt_len=8, max_new=8)
    assert set(out) == LLM_KEYS, out
    assert out["backend"] == "cpu" and out["geometry"] == "tiny"


def test_e2e_and_serve_small_return_bench_py_keys(monkeypatch):
    monkeypatch.setenv("MEMEX_SEARCH_MAX_BATCH", "4")
    e2e = bench.bench_e2e("cpu", n_docs=4, n_serial=4, n_threads=2, per=2)
    assert set(e2e) == E2E_KEYS
    assert e2e["query_store_rows"] > 0
    serve = bench.bench_serve_1m("cpu", n=4096, n_serial=4, n_settle=2, n_threads=4, per=2,
                                 http_clients=2, http_per=2)
    assert set(serve) == SERVE_KEYS
    assert serve["rows"] == 4096 and serve["http_qps"] > 0 and serve["batches"] > 0


def test_bulk_load_small():
    assert bench.bench_bulk_load("cpu", n=4096) > 0


# -- main ------------------------------------------------------------------------------


def test_main_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert capsys.readouterr().out == ""  # no result line


def test_default_doc_path_is_under_build_not_memex_tpus_record():
    assert Path(bench.DOC_PATH) == ROOT / "build" / "memex_tpu_torch" / "BENCH_FULL.json"


def test_main_skips_for_budget_and_leaves_the_root_record(monkeypatch, tmp_path, capsys):
    """A zero budget skips every stage after the kernels and records why;
    the sidecar goes to the default path (here redirected) and memex_tpu's
    root BENCH_FULL.json stays byte for byte as it was."""
    root_doc = ROOT / "BENCH_FULL.json"
    before = hashlib.sha256(root_doc.read_bytes()).hexdigest()
    monkeypatch.delenv("MEMEX_BENCH_DOC_PATH", raising=False)
    monkeypatch.setattr(bench, "DOC_PATH", str(tmp_path / "sub" / "BENCH_FULL.json"))
    monkeypatch.setenv("MEMEX_BENCH_BUDGET_S", "0")
    monkeypatch.setenv("MEMEX_BENCH_SKIP_LLM_DECODE", "1")
    monkeypatch.setattr(bench, "bench_kernels", _tiny_kernels)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    stages = ["scale_10M", "sharded_ivf_1M", "recall_vs_hnsw", "llm_decode", "ivf_prune_realtext",
              "sotu_e2e", "e2e", "serve_1M", "bulk_load_1M_s"]
    assert [s["stage"] for s in full["skipped_stages"]] == stages
    assert [s["why"] == "env" for s in full["skipped_stages"]] == [
        s == "llm_decode" for s in stages]
    assert compact["skipped_stages"] == len(stages) and compact["errors"] == 0
    assert compact["backend"] == "cpu" and compact["storage_tier"]
    assert json.loads((tmp_path / "sub" / "BENCH_FULL.json").read_text()) == full
    assert hashlib.sha256(root_doc.read_bytes()).hexdigest() == before


_REAL_KERNELS = bench.bench_kernels


def _tiny_kernels(device, on_tier=None):
    return _REAL_KERNELS(device, on_tier, n=4096, chain=1, chain_big=1, reps=1)


def test_main_runs_every_stage_under_bench_py_keys(monkeypatch, tmp_path, capsys):
    """Every stage through main's scheduler, each at its small size: the
    e2e keys merge into `e2e` itself, the others sit under their stage."""
    small = {
        "bench_kernels": _tiny_kernels,
        "bench_scale_10m": lambda device: {"n": 1},
        "bench_sharded_ivf": lambda device: {"n": 2},
        "bench_recall_vs_hnsw": lambda device: {"skipped": "x"},
        "bench_llm": lambda device: {"stream_tok_per_s": 1.0, "batch_tok_per_s": 2.0},
        "bench_realtext_ivf": lambda device: {"encode_windows_per_s": 3.0},
        "bench_sotu": lambda device: {"windows": 4},
        "bench_e2e": lambda device: {"ingest_docs_per_s": 1.234567},
        "bench_serve_1m": lambda device: {"qps": 5.0, "p50_ms": 1.0, "qps_vs_capability": 0.5},
        "bench_bulk_load": lambda device: 0.123456,
    }
    for name, fn in small.items():
        monkeypatch.setattr(bench, name, fn)
    monkeypatch.setenv("MEMEX_BENCH_DOC_PATH", str(tmp_path / "doc.json"))
    monkeypatch.setenv("MEMEX_BENCH_BUDGET_S", "3000")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    e2e = full["e2e"]
    assert e2e["scale_10M"] == {"n": 1} and e2e["sharded_ivf_1M"] == {"n": 2}
    assert e2e["ingest_docs_per_s"] == 1.23 and e2e["bulk_load_1M_s"] == 0.12
    assert e2e["llm_decode"]["stream_tok_per_s"] == 1.0
    assert e2e["ivf_prune_realtext"] == {"encode_windows_per_s": 3.0}
    assert e2e["sotu_e2e"] == {"windows": 4}
    assert compact["encode_windows_per_s"] == 3.0
    assert full["skipped_stages"] == []
    assert compact["llm_stream_ratio"] == 0.5 and compact["serve_1M"]["qps"] == 5.0
    assert compact["errors"] == 0 and len(full["tiers"]) == len(TIERS)


def test_main_records_a_kernels_failure_and_goes_on(monkeypatch, tmp_path, capsys):
    def boom(device, on_tier=None):
        raise RuntimeError("kernel launch failed: cudaError 700")

    monkeypatch.setattr(bench, "bench_kernels", boom)
    monkeypatch.setenv("MEMEX_BENCH_DOC_PATH", str(tmp_path / "doc.json"))
    monkeypatch.setenv("MEMEX_BENCH_BUDGET_S", "0")
    assert bench.main(["--device", "cpu"]) == 0
    compact = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert compact["errors"] == 1 and compact["error_stages"] == ["kernels"]
    assert compact["value"] == 0.0 and compact["skipped_stages"] == 9
