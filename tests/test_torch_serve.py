"""The port's slice as a whole: HTTP ingest then search through
memex_tpu's API server and worker, driven once with memex_tpu's Runtime
and once with the port's TorchRuntime, over the same checkpoint."""

import asyncio
import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

os.environ["MEMEX_FAKE_LLM"] = "1"

from memex_tpu.api.server import create_app
from memex_tpu.config import Settings
from memex_tpu.runtime import Runtime
from memex_tpu.text.tokenizer import _build_fallback_vocab
from memex_tpu.worker import Worker
from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, save_params
from memex_tpu_torch.runtime import TorchRuntime

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 64
# Both encoders run bf16 dense layers over a bf16 residual stream and
# round at slightly different points (nn.Linear rounds once after its fused
# bias add, JAX rounds the product and the sum), so a text's unit vector
# differs by a few bf16 ulps between packages. The cosine scores then differ
# by ~1e-4 (1.3e-4 measured on this corpus); 2e-3 leaves a 15x margin.
# Random-weight embeddings are concentrated, so neighbouring scores can
# still lie within it: ids may swap only among such near-ties.
SCORE_TOL = 2e-3


def _docs(seed: int, n: int) -> list[str]:
    rng = random.Random(seed)
    words = ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randint(3, 8)))
             for _ in range(400)]
    # Mostly one window; every fourth document spans several windows.
    return [" ".join(rng.choice(words) for _ in range(rng.randint(8, 20) if i % 4 else 150))
            for i in range(n)]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("model"))
    vocab = _build_fallback_vocab()
    cfg = MiniLMConfig(vocab_size=len(vocab), hidden_size=DIM, num_layers=2, num_heads=4,
                       intermediate_size=128)
    save_params(path, cfg, MiniLM(cfg).init_random(0), vocab=vocab)
    return path


def _settings(tmp_path, name, model_dir, query="", scheme="tpu"):
    s = Settings.from_env(db_uri=f"sqlite://{tmp_path}/{name}.db",
                          vector_uri=f"{scheme}://{tmp_path}/{name}_vectors{query}",
                          embedding_model=model_dir)
    s.embedding_dim = DIM
    return s


def _ingest_and_search(rt, docs, queries, limit):
    worker = Worker(rt, poll_interval=0.01)

    async def go(client):
        for d in docs:  # sequential: task ids, hence segment uuids, match
            resp = await client.post("/api/collections/notes", json={"content": d})
            assert resp.status == 200
        assert worker.drain(timeout=300)
        out = []
        for q in queries:
            resp = await client.get("/api/collections/notes/search",
                                    json={"query": q, "limit": limit})
            assert resp.status == 200
            out.append((await resp.json())["result"]["results"])
        return out

    async def with_client():
        client = TestClient(TestServer(create_app(rt)))
        await client.start_server()
        try:
            return await go(client)
        finally:
            await client.close()

    try:
        return asyncio.new_event_loop().run_until_complete(with_client())
    finally:
        rt.search_batcher.close()


def _check_same_hits(ref, got):
    """Scores agree within SCORE_TOL position by position; an id may sit
    elsewhere only among hits whose scores lie within SCORE_TOL."""
    assert len(ref) == len(got)
    ref_score = {h["_id"]: h["score"] for h in ref}
    for i, (a, b) in enumerate(zip(ref, got)):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL, (i, a["score"], b["score"])
        if a["_id"] != b["_id"]:
            # b's hit is a near-tie of the reference hit at this position:
            # either ranked nearby in the reference, or just past its end.
            other = ref_score.get(b["_id"], ref[-1]["score"])
            assert abs(other - a["score"]) <= 2 * SCORE_TOL, (i, a, b)


def _http_parity(tmp_path, model_dir, query="", scheme="tpu"):
    docs = _docs(1, 12)
    queries = docs[:4] + [" ".join(d.split()[:5]) for d in docs[4:8]]
    limit = 5
    ref = _ingest_and_search(Runtime(_settings(tmp_path, "jax", model_dir, query, scheme)),
                             docs, queries, limit)
    rt = TorchRuntime(_settings(tmp_path, "torch", model_dir, query, scheme), device="cpu")
    got = _ingest_and_search(rt, docs, queries, limit)
    for q, r, g in zip(queries, ref, got):
        assert len(g) == len(r) == limit
        _check_same_hits(r, g)
    for i in range(4):  # a document's exact text finds one of its segments first
        assert got[i][0]["content"] in docs[i]
        assert got[i][0]["document_id"] == ref[i][0]["document_id"]
    return rt


def test_http_ingest_then_search_matches_jax(tmp_path, model_dir):
    _http_parity(tmp_path, model_dir)


def test_http_int8_refine_store_matches_jax(tmp_path, model_dir):
    """The same flow on an int8 store with a residual-refinement rerank."""
    rt = _http_parity(tmp_path, model_dir, "?dtype=int8&refine=true")
    index = rt.store("notes").index
    assert index.dtype == "int8" and index.refine and index.rerank == 128


def test_http_ivf_store_matches_jax(tmp_path, model_dir):
    """The same flow on a `tpu+ivf://` store (below its clustering floor,
    so searches run its spill), searched through the batcher's non-fused
    path with the maintenance hook wired."""
    rt = _http_parity(tmp_path, model_dir, "?n_clusters=8&nprobe=2&dtype=int8", "tpu+ivf")
    store = rt.store("notes")
    assert type(store).__name__ == "TpuIVFStore" and store.index.dtype == "int8"
    assert store.on_maintenance == rt._enqueue_maintenance


def test_fused_query_path_int4_shift_matches_jax(model_dir, monkeypatch):
    """The port's FusedQueryPath on an int4 store at a batch that buckets
    above 64 (int4's shift unpack), against memex_tpu's FlatIndex.search
    (Pallas in interpret mode, also shift mode above Q = 64) on the same
    query vectors."""
    from memex_tpu.index.flat import FlatIndex as JaxFlat
    from memex_tpu_torch.embed import EmbeddingEngine
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.serve import query_path
    from memex_tpu_torch.store.flat_store import TpuFlatStore

    engine = EmbeddingEngine(model_dir, device="cpu")
    docs = _docs(2, 300)
    vecs = engine.encode_batch(docs)
    store = TpuFlatStore(None, "c", dim=DIM, dtype="int4", use_fused=True, device="cpu")
    store.index.add(vecs, [f"d{i}" for i in range(len(docs))])
    jx = JaxFlat(DIM, dtype="int4", use_fused=True)
    jx._interpret = True
    jx.add(vecs, [f"d{i}" for i in range(len(docs))])
    texts = docs[:70]
    seen = {}
    encode, bank = engine.encode_ids, ft.int4q_candidates

    def capture_encode(ids, mask):
        seen["queries"] = encode(ids, mask)
        return seen["queries"]

    def capture_bank(*args, **kw):
        seen["deferred"] = kw["deferred"]
        return bank(*args, **kw)

    monkeypatch.setattr(engine, "encode_ids", capture_encode)
    monkeypatch.setattr(ft, "int4q_candidates", capture_bank)
    got = query_path.FusedQueryPath(engine).search_texts(store, texts, 10)
    assert seen["deferred"] is False and seen["queries"].shape[0] == 128
    ref = jx.search(seen["queries"][: len(texts)].numpy(), 10)
    for r, g in zip(ref, got, strict=True):
        assert [sid for sid, _ in g] == [sid for sid, _ in r]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in r], rtol=0, atol=2e-5)
    assert all(g[0][0] == f"d{i}" for i, g in enumerate(got))


_ALONE = textwrap.dedent("""
    import asyncio, json, os, sys, tempfile
    sys.path.insert(0, sys.argv[1])
    os.environ["MEMEX_FAKE_LLM"] = "1"
    import torch
    torch.set_num_threads(2)
    from aiohttp.test_utils import TestClient, TestServer
    from memex_tpu.api.server import create_app
    from memex_tpu.config import Settings
    from memex_tpu.worker import Worker
    from memex_tpu_torch.runtime import TorchRuntime

    tmp = tempfile.mkdtemp(dir=sys.argv[2])
    s = Settings.from_env(db_uri=f"sqlite://{tmp}/t.db",
                          vector_uri=f"{sys.argv[6]}://{tmp}/vec?use_fused=1{sys.argv[5]}",
                          embedding_model=sys.argv[3])
    s.embedding_dim = int(sys.argv[4])
    rt = TorchRuntime(s, device="cpu")
    worker = Worker(rt, poll_interval=0.01)

    async def go():
        c = TestClient(TestServer(create_app(rt)))
        await c.start_server()
        try:
            r = await c.post("/api/collections/c", json={"content": "alpha beta gamma"})
            assert r.status == 200
            assert worker.drain(timeout=120)
            r = await c.get("/api/collections/c/search", json={"query": "alpha", "limit": 1})
            return (await r.json())["result"]["results"]
        finally:
            await c.close()

    hits = asyncio.new_event_loop().run_until_complete(go())
    rt.search_batcher.close()
    print(json.dumps({"hits": len(hits), "jax": "jax" in sys.modules}))
""")


def test_port_alone_never_imports_jax(tmp_path, model_dir):
    """This process already imported jax (conftest), so the check runs in
    a fresh interpreter: a full ingest and search through the port, on a
    float32 store, on an int8 store with refine and on an IVF store."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    for scheme, query in (("tpu", ""), ("tpu", "&dtype=int8&refine=true"),
                          ("tpu+ivf", "&n_clusters=4&dtype=int8")):
        out = subprocess.run([sys.executable, "-c", _ALONE, ROOT, str(tmp_path), model_dir,
                              str(DIM), query, scheme], capture_output=True, text=True,
                             timeout=300, env=env, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result == {"hits": 1, "jax": False}


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    from memex_tpu_torch import __main__ as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["serve", "--device", "cuda"]) == 2


def test_registry_schemes(tmp_path):
    from memex_tpu_torch.store import registry
    from memex_tpu_torch.store.flat_store import MemoryStore, TpuFlatStore

    from memex_tpu_torch.store.ivf_store import TpuIVFStore

    for scheme in ("tpu+mesh", "tpu+ivf+mesh"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            registry.get_vector_storage(f"{scheme}://{tmp_path}/x", "c", device="cpu")
    ivf = registry.get_vector_storage(f"tpu+ivf://{tmp_path}/i?n_clusters=8", "c", dim=8,
                                      device="cpu")
    assert isinstance(ivf, TpuIVFStore) and ivf.index.C == 8
    flat = registry.get_vector_storage(f"tpu://{tmp_path}/f?dtype=bfloat16&rerank=8",
                                       "c", dim=8, device="cpu")
    assert isinstance(flat, TpuFlatStore)
    assert flat.index.dtype == "bfloat16" and flat.index.rerank == 8
    assert registry.get_vector_storage(f"tpu://{tmp_path}/f?dtype=bfloat16&rerank=8",
                                       "c", dim=8, device="cpu") is flat
    mem = registry.get_vector_storage("memory://", f"m-{tmp_path.name}", dim=8, device="cpu")
    assert isinstance(mem, MemoryStore)
    with pytest.raises(ValueError):
        registry.get_vector_storage("nope://x", "c", device="cpu")


def test_local_llm_config_is_refused(tmp_path, monkeypatch):
    monkeypatch.delenv("MEMEX_FAKE_LLM", raising=False)
    s = Settings.from_env(db_uri=f"sqlite://{tmp_path}/t.db", local_llm_config="llm.json")
    s.openai_api_key = None
    with pytest.raises(RuntimeError, match="ROADMAP"):
        TorchRuntime(s, device="cpu").llm
