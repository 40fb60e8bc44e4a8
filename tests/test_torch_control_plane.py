"""The port's copy of memex_tpu's JAX-free control plane against the
original, on the CPU: token ids and encoder windows, the id namespace and
segment ids, the SQLite schema both packages migrate to, and the route
table of both HTTP apps."""

import random
import sqlite3

import numpy as np
import pytest

import memex_tpu
import memex_tpu_torch
from memex_tpu.api.server import create_app as jax_create_app
from memex_tpu.config import Settings as JaxSettings
from memex_tpu.db import models as jax_models
from memex_tpu.db.connection import create_connection_by_uri as jax_connect
from memex_tpu.runtime import Runtime
from memex_tpu.text import WordPieceTokenizer as JaxTokenizer
from memex_tpu.text import encode_windows as jax_encode_windows
from memex_tpu.text.segment import segment_text as jax_segment_text
from memex_tpu.text.segment import split_text as jax_split_text
from memex_tpu.text.segment import window_token_ids as jax_window_token_ids
from memex_tpu.text.tokenizer import _build_fallback_vocab as jax_fallback_vocab
from memex_tpu_torch.api.server import create_app
from memex_tpu_torch.config import Settings
from memex_tpu_torch.db import models
from memex_tpu_torch.db.connection import create_connection_by_uri
from memex_tpu_torch.runtime import TorchRuntime
from memex_tpu_torch.text import WordPieceTokenizer, encode_windows
from memex_tpu_torch.text.segment import segment_text, split_text, window_token_ids
from memex_tpu_torch.text.tokenizer import _build_fallback_vocab

WORDS = ["memory", "search", "vector", "index", "query", "token", "window", "##ing", "##s",
         "##ed", "un", "##able", "café", "naïve", "北京", "x" * 120]


def _corpus(seed: int, n: int = 40) -> list[str]:
    """Seeded documents: ASCII words, word pieces, accents, CJK, digits,
    punctuation, an over-long word, blank runs and a few long documents."""
    rng = random.Random(seed)
    pieces = WORDS + ["Hello,", "world!", "(a)", "[b]", "3.14", "e-mail", "don't", "über",
                      "Ñandú", "東京都", "  ", "\t", "\n"]
    docs = []
    for i in range(n):
        length = rng.randint(400, 900) if i % 10 == 0 else rng.randint(1, 40)
        docs.append(" ".join(rng.choice(pieces) for _ in range(length)))
    return docs + ["", " ", "a"]


def _vocab(fallback) -> list[str]:
    """The fallback vocab plus whole words, so WordPiece splits words too."""
    return fallback() + [w for w in WORDS if w not in fallback()]


@pytest.fixture(scope="module", params=["native", "python"])
def tokenizers(request):
    """Both packages' tokenizers over the same vocab, on the native C++
    WordPiece (where native/ builds) or forced onto the Python one."""
    jax_tok = JaxTokenizer(vocab=_vocab(jax_fallback_vocab))
    tok = WordPieceTokenizer(vocab=_vocab(_build_fallback_vocab))
    if request.param == "python":
        jax_tok._native = tok._native = False
    return jax_tok, tok


def test_fallback_vocab_is_memex_tpus():
    assert _build_fallback_vocab() == jax_fallback_vocab()


def test_token_ids_match(tokenizers):
    jax_tok, tok = tokenizers
    for doc in _corpus(0):
        assert tok.encode(doc) == jax_tok.encode(doc)
        assert tok.encode(doc, add_special_tokens=False) == jax_tok.encode(
            doc, add_special_tokens=False)
        assert tok.tokenize(doc) == jax_tok.tokenize(doc)
        ids = jax_tok.encode(doc)
        assert tok.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("max_length,stride", [(32, 8), (256, 86)])
def test_windows_match(tokenizers, max_length, stride):
    jax_tok, tok = tokenizers
    docs = _corpus(1)
    for doc in docs:
        raw = jax_tok.encode(doc, add_special_tokens=False)
        assert (window_token_ids(raw, tok, max_length, stride)
                == jax_window_token_ids(raw, jax_tok, max_length, stride))
        assert (segment_text(doc, tok, max_length, stride)
                == jax_segment_text(doc, jax_tok, max_length, stride))
    ids, mask = encode_windows(docs, tok, max_length)
    jax_ids, jax_mask = jax_encode_windows(docs, jax_tok, max_length)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(mask, jax_mask)


def test_split_text_matches():
    for doc in _corpus(2):
        for budget in (5, 50, 500):
            assert split_text(doc, budget) == jax_split_text(doc, budget)


def test_namespace_and_segment_ids_match():
    assert memex_tpu_torch.NAMESPACE == memex_tpu.NAMESPACE
    rng = random.Random(3)
    for task_id in [1, 2, 17, 4096] + [rng.randrange(1, 1 << 31) for _ in range(20)]:
        doc = models.document_uuid_for_task(task_id)
        assert doc == jax_models.document_uuid_for_task(task_id)
        for idx in (0, 1, 7, 300):
            assert models.segment_uuid(doc, idx) == jax_models.segment_uuid(doc, idx)


def _schema(path) -> list[tuple]:
    with sqlite3.connect(path) as conn:
        return sorted(conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master"))


def test_sqlite_schema_matches(tmp_path):
    """Both packages' migrations give the same sqlite_master, and each
    package opens (and migrates) the other's file without changing it."""
    jax_path, path = tmp_path / "jax.db", tmp_path / "torch.db"
    jax_connect(f"sqlite://{jax_path}").close()
    create_connection_by_uri(f"sqlite://{path}").close()
    schema = _schema(path)
    assert schema and schema == _schema(jax_path)
    create_connection_by_uri(f"sqlite://{jax_path}").close()
    jax_connect(f"sqlite://{path}").close()
    assert _schema(jax_path) == _schema(path) == schema


def _routes(app) -> list[tuple[str, str]]:
    return sorted((r.method, r.resource.canonical) for r in app.router.routes())


def test_route_tables_match(tmp_path, monkeypatch):
    monkeypatch.setenv("MEMEX_FAKE_LLM", "1")
    jax_rt = Runtime(JaxSettings.from_env(db_uri=f"sqlite://{tmp_path}/jax.db",
                                          vector_uri=f"memory://{tmp_path}/jax"))
    rt = TorchRuntime(Settings.from_env(db_uri=f"sqlite://{tmp_path}/torch.db",
                                        vector_uri=f"memory://{tmp_path}/torch"), device="cpu")
    routes = _routes(create_app(rt))
    assert len(routes) >= 14
    assert routes == _routes(jax_create_app(jax_rt))


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    """metrics.profile_trace writes a torch.profiler Chrome trace where
    memex_tpu writes a JAX one, and nothing without MEMEX_PROFILE."""
    import json

    import torch

    from memex_tpu_torch.metrics import profile_trace

    monkeypatch.delenv("MEMEX_PROFILE", raising=False)
    with profile_trace("idle"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("MEMEX_PROFILE", str(tmp_path / "traces"))
    for _ in range(2):
        with profile_trace("batch.encode"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = sorted(p.name for p in (tmp_path / "traces").iterdir())
    assert len(files) == 2 and all(f.startswith("batch.encode.") for f in files)
    events = json.loads((tmp_path / "traces" / files[0]).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


class _Reply:
    def __init__(self, ok: bool):
        self.ok, self.text = ok, "" if ok else "refused"


@pytest.mark.parametrize("exists,accept", [(True, True), (False, True), (False, False)])
def test_qdrant_helper_sends_memex_tpus_requests(exists, accept, monkeypatch):
    """The port's copy of store/qdrant_helper.py makes the same REST calls
    as memex_tpu's (recorded through a stub of `requests`; no server) and
    gives the same answers."""
    import requests

    from memex_tpu.store import qdrant_helper as jax_qdrant
    from memex_tpu_torch.store import qdrant_helper as qdrant

    log: list = []

    def get(url, timeout):
        log.append(("GET", url, timeout))
        if url.endswith("/healthz") and not accept:
            raise requests.ConnectionError("down")
        return _Reply(exists or url.endswith("/healthz"))

    def put(url, json, timeout):
        log.append(("PUT", url, json, timeout))
        return _Reply(accept)

    monkeypatch.setattr(requests, "get", get)
    monkeypatch.setattr(requests, "put", put)
    runs = []
    for mod in (jax_qdrant, qdrant):
        log.clear()
        helper = mod.QdrantHelper("http://localhost:6333/", timeout=2.5)
        answers = (helper.healthy(), helper.ensure_collection("docs"),
                   helper.ensure_collection("small", dim=8, on_disk=False))
        runs.append((answers, list(log)))
    assert runs[0] == runs[1]
    assert runs[1][0] == (accept, exists or accept, exists or accept)
    assert qdrant.DEFAULT_DIM == jax_qdrant.DEFAULT_DIM == 384


@pytest.mark.parametrize("value", [None, "off", "OFF", "0", "none", "", "cache"])
def test_compile_cache_picks_the_kernel_build_directory(value, tmp_path, monkeypatch):
    """MEMEX_COMPILE_CACHE, read as memex_tpu's `serve` reads it for XLA's
    cache, places the port's kernel library: unset, the repository's
    git-ignored build/memex_tpu_torch/; off/0/none/empty, one temporary
    directory of the process; any other value, that directory."""
    import os
    import tempfile

    from memex_tpu_torch import kernels

    repo_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "build", "memex_tpu_torch")
    if value is None:
        monkeypatch.delenv("MEMEX_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("MEMEX_COMPILE_CACHE",
                           str(tmp_path / value) if value == "cache" else value)
    where = kernels.build_dir()
    assert os.path.dirname(kernels.library_path()) == where
    if value is None:
        assert where == repo_dir
    elif value == "cache":
        assert where == str(tmp_path / "cache")
    else:
        assert os.path.isdir(where) and where != repo_dir
        assert os.path.commonpath([where, tempfile.gettempdir()]) == tempfile.gettempdir()
        assert kernels.build_dir() == where  # one directory for the process
