"""tests/test_sotu_e2e.py's three tests on the port: a real document through
the port's API path (tokenizer, windower, the tiny MiniLM of
tests/test_torch_engine.py, the int8 store), top-3 search, the int8 store
against the HNSW store on the same embeddings, and the window round trip.

Each runs on the upstream demo document at the port's SOTU_PATH, inside the
checkout (skipped when it is absent, as memex_tpu's are), and on SURVEY.md, real English prose
in the repository, each with probe words its windows must hold.
"""

import asyncio
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from memex_tpu_torch.bench import SOTU_PATH
from memex_tpu_torch.config import Settings
from memex_tpu_torch.runtime import TorchRuntime
from memex_tpu_torch.store.base import VectorData
from memex_tpu_torch.store.flat_store import TpuFlatStore
from memex_tpu_torch.store.hnsw_store import HnswStore
from memex_tpu_torch.worker import Worker
from test_torch_engine import jax_params, model_dir, port_engine  # noqa: F401

torch.set_num_threads(2)

SURVEY = str(Path(__file__).resolve().parent.parent / "SURVEY.md")

DOCS = {
    "sotu": (SOTU_PATH, ("union", "america", "jobs")),
    "survey": (SURVEY, ("memex", "search", "index")),
}


@pytest.fixture(params=list(DOCS))
def doc(request):
    path, probes = DOCS[request.param]
    if not os.path.exists(path):
        pytest.skip("reference corpus not present")
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read(), probes


@pytest.fixture
def engine(model_dir, monkeypatch):  # noqa: F811
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    return port_engine(model_dir, 32)


def test_sotu_ingest_and_top3_search(tmp_path, doc, engine, monkeypatch):
    """Enqueue -> worker ingest (window, encode, store) -> top-3 semantic
    search through the API."""
    from aiohttp.test_utils import TestClient, TestServer

    from memex_tpu_torch.api.server import create_app

    monkeypatch.setenv("MEMEX_FAKE_LLM", "1")
    text, _ = doc
    settings = Settings.from_env(db_uri=f"sqlite://{tmp_path}/sotu.db",
                                 vector_uri=f"tpu://{tmp_path}/vec?dtype=int8")
    settings.embedding_dim = 64
    rt = TorchRuntime(settings, device="cpu")
    rt._engine = engine

    async def flow():
        client = TestClient(TestServer(create_app(rt)))
        await client.start_server()
        try:
            resp = await client.post("/api/collections/sotu", json={"content": text})
            assert resp.status == 200
            task_id = (await resp.json())["result"]["taskId"]
            worker = Worker(rt, poll_interval=0.01)
            worker.start_background()
            try:
                for _ in range(600):
                    resp = await client.get(f"/api/tasks/{task_id}")
                    status = (await resp.json())["result"]["status"]
                    if status in ("Completed", "Failed"):
                        break
                    await asyncio.sleep(0.2)
                assert status == "Completed"
                resp = await client.post("/api/collections/sotu/search",
                                         json={"query": "jobs economy america", "limit": 3})
                assert resp.status == 200
                return (await resp.json())["result"]["results"]
            finally:
                worker.shutdown()
        finally:
            await client.close()

    try:
        results = asyncio.new_event_loop().run_until_complete(flow())
        assert len(results) == 3
        for seg in results:
            assert set(seg) >= {"_id", "document_id", "segment", "content", "score"}
            assert seg["content"]
            assert -1.001 <= seg["score"] <= 1.001
        # Thousands of tokens: dozens of 64-token windows.
        assert rt.store("sotu").count >= 20
    finally:
        rt.search_batcher.close()


def test_sotu_tpu_store_matches_hnsw(tmp_path, doc, engine):
    """The same embeddings in two stores: the int8 flat store's top result
    is HNSW's (the reference backend) and their top-k overlap."""
    text, _ = doc
    segments, vecs = engine.encode(text)
    n = len(segments)
    assert n >= 20
    data = [VectorData(id=f"s{i}", document_id="doc", text=segments[i], vector=vecs[i])
            for i in range(n)]
    tpu = TpuFlatStore(str(tmp_path / "t"), "sotu", dim=64, dtype="int8", device="cpu")
    hnsw = HnswStore(str(tmp_path / "h"), "sotu", dim=64)
    tpu.add_vectors(data)
    hnsw.add_vectors(data)
    qv = engine.encode_single("the state of our union is strong")
    for k in (3, 10):
        a = [h.id for h in tpu.search(qv, k)]
        b = [h.id for h in hnsw.search(qv, k)]
        assert a[0] == b[0]
        assert len(set(a) & set(b)) >= k - max(1, k // 5)


def test_sotu_window_roundtrip(doc, engine):
    """The windower covers the document: the probe words are in the decoded
    windows."""
    text, probes = doc
    segments, vecs = engine.encode(text)
    assert len(segments) == len(vecs)
    assert np.all(np.isfinite(vecs))
    joined = " ".join(segments).lower()
    for probe in probes:
        assert probe in joined
