"""bench.py's real-text stages in the port (memex_tpu_torch/bench.py:
`ivf_prune_realtext`, `sotu_e2e`, `_resolve_weights`) against memex_tpu's
root bench.py on the CPU, both on SURVEY.md (the upstream demo document the
stages read by default is not in the repository).

memex_tpu's stages read a fixed path: here its module sees SURVEY.md there
(its `open` and `os.path.exists` answer for that one file name); the port's
take `path=`. Both encoders are the tiny MiniLM (hidden 64, 2 layers, float32
compute, L = 64, stride 16) of tests/test_torch_engine.py, memex_tpu's
weights carried into the port with `params_from_numpy`. No test opens a
connection: `socket.create_connection` and `subprocess.run` are patched.

- The windows and their token ids are memex_tpu's, bit for bit.
- `_encode_bulk`'s float16-fetched vectors are within FETCH_ATOL of
  memex_tpu's (tests/test_torch_engine.py's bound: a rounding step apart).
- On the same vectors (memex_tpu's engine handed the port's) and memex_tpu's
  k-means initialisation, every tier's operating point, tie-aware and id
  recall and union sizes equal memex_tpu's, as do the stage's keys.
- `bench_sotu` through the queue and the worker: the store's top-3 windows
  for each query equal memex_tpu's.
"""

import builtins
import json
import os
import socket
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
import memex_tpu.config as jconfig
import memex_tpu.embed as jembed
import memex_tpu.text as jtext
import memex_tpu_torch.config as tconfig
import memex_tpu_torch.embed as tembed
import memex_tpu_torch.index.ivf as tivf
import memex_tpu_torch.text as ttext
from memex_tpu.store.tpu_store import TpuFlatStore as JaxFlatStore
from memex_tpu_torch import bench
from memex_tpu_torch.store.flat_store import TpuFlatStore
from test_torch_engine import (FETCH_ATOL, jax_engine, jax_params,  # noqa: F401
                               model_dir, port_engine)
from test_torch_ivf import _jax_init

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SURVEY = str(ROOT / "SURVEY.md")
DOC_NAME = "state_of_the_union_2023.txt"  # the file name memex_tpu's stages read
NW = 384  # windows of the realtext runs (bench.py's default is 16,384)
TIERS = ("int8", "int8_refine", "float32")
# bench.py:1352-1424, the stage's keys.
REALTEXT_KEYS = {"windows", "encode_s", "encode_windows_per_s", "encode_roofline",
                 "mean_pairwise_cos", "weights", "weights_fallback_reason", *TIERS}
ROOFLINE_KEYS = {"tokenize_s", "dispatch_s", "device_s", "fetch_s", "fetch_dtype",
                 "windows_per_s_device", "achieved_tflops", "pct_peak_mxu", "bound"}
TIER_KEYS = {"operating_point", "recall_at_10_vs_exact_f32", "id_recall_at_10",
             "union_clusters_full", "union_clusters_pruned"}
SOTU_KEYS = {"windows", "ingest_s", "query_p50_ms", "top3_score", "recall_at_10_int8_vs_f32",
             "weights", "weights_fallback_reason"}  # bench.py:1495-1506
_FIT = tivf.kmeans_fit
_OPEN = builtins.open
_EXISTS = os.path.exists


def _refuse(*a, **kw):
    raise OSError("no network in the tests")


def _no_subprocess(*a, **kw):
    raise AssertionError("the test ran a subprocess")


def jax_reads_survey(mp):
    """memex_tpu's bench module reads SURVEY.md where it reads its document."""
    def redirect(path):
        return SURVEY if str(path).endswith(DOC_NAME) else path

    mp.setattr(jbench, "open", lambda p, *a, **kw: _OPEN(redirect(p), *a, **kw), raising=False)
    mp.setattr(os.path, "exists", lambda p: _EXISTS(redirect(p)))


def offline(mp):
    mp.setattr(socket, "create_connection", _refuse)
    mp.setattr(subprocess, "run", _no_subprocess)


def shared_kmeans_init(mp):
    """The port's k-means starts from memex_tpu's initial rows."""
    def with_jax_init(vectors, n_clusters, iters=10, seed=0, **kw):
        init = torch.from_numpy(_jax_init(vectors.shape[0], n_clusters, seed))
        return _FIT(vectors, n_clusters, iters, seed, init=init)

    mp.setattr(tivf, "kmeans_fit", with_jax_init)


def tiny_engines(mp, jax_p, mdir, jax_bulk=None):
    """Both packages' EmbeddingEngine constructors give the tiny engines
    (max_batch 8, so 64 windows take the bulk path). jax_bulk replaces
    memex_tpu's _encode_bulk output (the same vectors on both sides)."""
    made = {}

    def port(model_dir=None, fetch_dtype=None, **kw):
        made["port"] = port_engine(mdir, 8, fetch_dtype=fetch_dtype or "float32")
        return made["port"]

    def handed(ids, mask, out, phases=None):
        if phases is not None:
            phases.update(dispatch_s=0.0, device_sync_s=0.0, fetch_s=0.0)
        return jax_bulk(ids).copy()

    def jax(model_dir=None, fetch_dtype="float32", **kw):
        eng = jax_engine(jax_p, 8, fetch_dtype)
        if jax_bulk is not None:
            eng._encode_bulk = handed
        made["jax"] = eng
        return eng

    mp.setattr(tembed, "EmbeddingEngine", port)
    mp.setattr(jembed, "EmbeddingEngine", jax)
    return made


def capture(mp, module, name, box):
    """Record every return of module.name in box[name]."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        box.setdefault(name, []).append(out)
        return out

    mp.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def realtext(jax_params, model_dir):  # noqa: F811
    """Both stages at NW windows: the port's, then memex_tpu's on the port's
    vectors. Returns (port out, jax out, the port's windows and ids, its
    vectors, memex_tpu's own bulk vectors on the same ids)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEMEX_BENCH_REALTEXT_WINDOWS", str(NW))
        mp.delenv("MEMEX_MINILM_DIR", raising=False)
        offline(mp)
        jax_reads_survey(mp)
        shared_kmeans_init(mp)
        box: dict = {}
        capture(mp, ttext, "encode_windows", box)
        made = tiny_engines(mp, jax_params, model_dir)
        port_out = bench.bench_realtext_ivf("cpu", path=SURVEY)
        ids, mask = box["encode_windows"][0]
        vecs = made["port"]._encode_bulk(ids, mask, np.empty((NW, 64), np.float32))
        jax_vecs = jax_engine(jax_params, 8, "float16")._encode_bulk(
            ids, mask, np.empty((NW, 64), np.float32))
        # memex_tpu's stage on the port's vectors (its bulk path handed them).
        jbox: dict = {}
        capture(mp, jtext, "encode_windows", jbox)
        tiny_engines(mp, jax_params, model_dir, jax_bulk=lambda ids_: vecs)
        jax_out = jbench.bench_realtext_ivf()
    return port_out, jax_out, box["encode_windows"][0], jbox["encode_windows"][0], vecs, \
        jax_vecs


def test_windows_and_token_ids_are_memex_tpus(realtext):
    *_, (ids, mask), (jids, jmask), _, _ = realtext
    assert ids.shape == (NW, 64) and ids.dtype == jids.dtype
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    rng = np.random.default_rng(7)
    windows = bench.realtext_windows(Path(SURVEY).read_text(encoding="utf-8"), NW, rng)
    assert len(set(windows)) == NW and windows[5].endswith("(window 5)")
    tok = ttext.WordPieceTokenizer()
    np.testing.assert_array_equal(ttext.encode_windows(windows, tok, 64)[0], ids)


def test_encode_bulk_vectors_within_the_fetch_tolerance(realtext):
    *_, vecs, jax_vecs = realtext
    np.testing.assert_allclose(vecs, jax_vecs, rtol=0, atol=FETCH_ATOL)
    # float16 fetch: every component is a float16 value.
    np.testing.assert_array_equal(vecs, vecs.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("tier", TIERS)
def test_ivf_tier_gives_memex_tpus_operating_point_and_recall(realtext, tier):
    port_out, jax_out, *_ = realtext
    assert set(port_out[tier]) == set(jax_out[tier]) == TIER_KEYS
    assert port_out[tier] == jax_out[tier]
    assert 0.0 < port_out[tier]["recall_at_10_vs_exact_f32"] <= 1.0


def test_realtext_stage_keys_and_corpus_figures_are_memex_tpus(realtext):
    port_out, jax_out, *_ = realtext
    assert set(port_out) == set(jax_out) == REALTEXT_KEYS
    assert set(port_out["encode_roofline"]) == set(jax_out["encode_roofline"]) == ROOFLINE_KEYS
    for key in ("windows", "mean_pairwise_cos", "weights", "weights_fallback_reason"):
        assert port_out[key] == jax_out[key], key
    assert port_out["weights"] == "random"
    assert port_out["weights_fallback_reason"].startswith("offline, cannot fetch")
    roof = port_out["encode_roofline"]
    assert roof["fetch_dtype"] == "float16" and roof["bound"] in ("tokenize", "device", "fetch")
    # No device figure from a CPU run.
    assert roof["achieved_tflops"] is None and roof["pct_peak_mxu"] is None


def test_compact_line_carries_the_realtext_run(realtext):
    """A real run of the port's stage reaches the compact line under
    bench.py's keys, as memex_tpu's Reporter reads the same document."""
    port_out, *_ = realtext
    lines = []
    for mod in (bench, jbench):
        rep = mod.Reporter()
        rep.doc["e2e"]["ivf_prune_realtext"] = port_out
        lines.append(rep.compact())
    c = lines[0]
    assert c == lines[1]
    for tier in TIERS:
        assert c[f"realtext_{tier}_tie_recall"] == port_out[tier]["recall_at_10_vs_exact_f32"]
    assert c["encode_windows_per_s"] == port_out["encode_windows_per_s"] > 0
    assert c["encode_bound"] == port_out["encode_roofline"]["bound"]


def test_stages_without_their_document_are_skipped(monkeypatch, tmp_path):
    """bench.py's answer when the document is absent, before any weights
    probe or encoder."""
    monkeypatch.setattr(bench, "SOTU_PATH", str(tmp_path / DOC_NAME))
    monkeypatch.setattr(bench, "_resolve_weights", _no_subprocess)
    for fn in (bench.bench_realtext_ivf, bench.bench_sotu):
        assert fn("cpu") == {"skipped": "reference corpus not present"}
        assert fn("cpu", path=str(tmp_path / "nothing.txt")) == {
            "skipped": "reference corpus not present"}


# -- sotu_e2e ----------------------------------------------------------------------


def test_sotu_top3_through_the_worker_equals_memex_tpus(jax_params, model_dir,  # noqa: F811
                                                        monkeypatch):
    offline(monkeypatch)
    jax_reads_survey(monkeypatch)
    monkeypatch.delenv("MEMEX_MINILM_DIR", raising=False)
    tiny_engines(monkeypatch, jax_params, model_dir)
    for mod in (jconfig, tconfig):
        real = mod.Settings.from_env

        def from_env(real=real, **kw):
            s = real(**kw)
            s.embedding_dim = 64
            return s

        monkeypatch.setattr(mod.Settings, "from_env", staticmethod(from_env))
    top3 = {}
    for name, cls in (("port", TpuFlatStore), ("jax", JaxFlatStore)):
        real = cls.search_batch

        def recording(self, vectors, limit, real=real, name=name):
            hits = real(self, vectors, limit)
            rows = {f: i for i, f in enumerate(self.index.ids)}
            top3[name] = [[rows[h.id] for h in hs[:3]] for hs in hits]
            return hits

        monkeypatch.setattr(cls, "search_batch", recording)
    port_out = bench.bench_sotu("cpu", path=SURVEY)
    jax_out = jbench.bench_sotu()
    assert set(port_out) == set(jax_out) == SOTU_KEYS
    assert port_out["windows"] == jax_out["windows"] > 100
    assert len(top3["port"]) == len(bench.SOTU_QUERIES) == 8
    assert top3["port"] == top3["jax"]
    assert port_out["top3_score"] == pytest.approx(jax_out["top3_score"], abs=2e-4)
    assert port_out["recall_at_10_int8_vs_f32"] >= 0.9


# -- _resolve_weights ----------------------------------------------------------------


NEEDED = ("model.safetensors", "config.json", "vocab.txt")


def _weights_dir(path: Path) -> str:
    path.mkdir(parents=True)
    for f in NEEDED:
        (path / f).write_text("x")
    return str(path)


@pytest.fixture
def no_weights(monkeypatch, tmp_path):
    """No candidate directory holds weights: MEMEX_MINILM_DIR unset, HOME
    empty, and the repository candidate under tmp_path."""
    monkeypatch.delenv("MEMEX_MINILM_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(bench, "ROOT", str(tmp_path / "repo"))
    return tmp_path


def test_resolve_weights_uses_a_local_directory(no_weights, monkeypatch):
    monkeypatch.setattr(socket, "create_connection", _no_subprocess)
    monkeypatch.setattr(subprocess, "run", _no_subprocess)
    d = _weights_dir(no_weights / "mine")
    monkeypatch.setenv("MEMEX_MINILM_DIR", d)
    assert bench._resolve_weights() == jbench._resolve_weights() == (d, "real", None)
    monkeypatch.delenv("MEMEX_MINILM_DIR")
    home = _weights_dir(no_weights / "home" / ".cache" / "memex" / "models" / "all-MiniLM-L12-v2")
    assert bench._resolve_weights() == (home, "real", None)


def test_resolve_weights_offline_records_why(no_weights, monkeypatch):
    probes = []

    def refuse(addr, timeout=None):
        probes.append((addr, timeout))
        raise OSError("Name or service not known")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(subprocess, "run", _no_subprocess)
    want = ("random", "random",
            "offline, cannot fetch all-MiniLM-L12-v2 (Name or service not known)")
    assert bench._resolve_weights() == want
    assert jbench._resolve_weights() == want
    assert probes == [(("huggingface.co", 443), 5)] * 2


class _Conn:
    def close(self):
        pass


@pytest.mark.parametrize("outcome", ["failed", "fetched"])
def test_resolve_weights_download_goes_through_the_port_cli(no_weights, monkeypatch, outcome):
    calls = []
    tgt = no_weights / "repo" / "models" / "all-MiniLM-L12-v2"

    def run(argv, **kw):
        calls.append((argv, kw))
        if outcome == "fetched":
            _weights_dir(tgt)
            return subprocess.CompletedProcess(argv, 0, "", "")
        return subprocess.CompletedProcess(argv, 1, "", "HTTP 403 from the hub")

    monkeypatch.setattr(socket, "create_connection", lambda addr, timeout=None: _Conn())
    monkeypatch.setattr(subprocess, "run", run)
    got = bench._resolve_weights()
    (argv, kw), = calls
    assert argv[1:] == ["-m", "memex_tpu_torch", "download-model", "--target", str(tgt)]
    assert kw["timeout"] == 900 and kw["cwd"] == str(no_weights / "repo")
    if outcome == "fetched":
        assert got == (str(tgt), "real", None)
    else:
        assert got == ("random", "random", "download failed: HTTP 403 from the hub")


# -- main ------------------------------------------------------------------------------

ORDER = ["scale_10M", "sharded_ivf_1M", "recall_vs_hnsw", "llm_decode", "ivf_prune_realtext",
         "sotu_e2e", "e2e", "serve_1M", "bulk_load_1M_s"]  # bench.py:2016-2026


def _fast_stages(monkeypatch, tmp_path):
    for name in ("bench_scale_10m", "bench_sharded_ivf", "bench_recall_vs_hnsw", "bench_llm",
                 "bench_serve_1m"):
        monkeypatch.setattr(bench, name, lambda device, name=name: {"ran": name})
    monkeypatch.setattr(bench, "bench_e2e", lambda device: {"query_p50_ms": 1.0})
    monkeypatch.setattr(bench, "bench_bulk_load", lambda device: 1.0)
    monkeypatch.setattr(bench, "bench_kernels", lambda device, on_tier=None: {
        "f32": {"qps": 1.0, "p50_batch_ms": 1.0, "recall_at_10": 1.0, "query_batch": 32}})
    monkeypatch.setattr(bench, "SOTU_PATH", str(tmp_path / DOC_NAME))
    monkeypatch.setattr(bench, "_resolve_weights", _no_subprocess)
    monkeypatch.setenv("MEMEX_BENCH_DOC_PATH", str(tmp_path / "doc.json"))
    monkeypatch.setenv("MEMEX_BENCH_BUDGET_S", "3000")


def test_main_records_the_realtext_stages_in_bench_py_order(monkeypatch, tmp_path, capsys):
    _fast_stages(monkeypatch, tmp_path)
    assert bench.main(["--device", "cpu"]) == 0
    full = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    e2e = full["e2e"]
    keys = [k for k in e2e if k in ORDER or k == "query_p50_ms"]
    assert keys == [("query_p50_ms" if s == "e2e" else s) for s in ORDER]
    for stage in ("ivf_prune_realtext", "sotu_e2e"):
        assert e2e[stage] == {"skipped": "reference corpus not present"}
    assert full["skipped_stages"] == []


def test_main_skips_the_realtext_stages_by_env(monkeypatch, tmp_path, capsys):
    _fast_stages(monkeypatch, tmp_path)
    monkeypatch.setenv("MEMEX_BENCH_SKIP_IVF_PRUNE_REALTEXT", "1")
    monkeypatch.setenv("MEMEX_BENCH_SKIP_SOTU_E2E", "1")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    assert full["skipped_stages"] == [{"stage": "ivf_prune_realtext", "why": "env"},
                                      {"stage": "sotu_e2e", "why": "env"}]
    assert "ivf_prune_realtext" not in full["e2e"] and "sotu_e2e" not in full["e2e"]
    assert compact["skipped_stages"] == 2
