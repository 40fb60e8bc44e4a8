"""The port stands alone: no module of memex_tpu_torch, and not
chip_smoke.py, imports memex_tpu or jax, and a process that serves and
searches through the port never loads either."""

import ast
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("memex_tpu", "jax", "jaxlib")
FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "memex_tpu_torch").rglob("*.py"))
FILES.append("chip_smoke.py")


def _imported_roots(tree: ast.AST):
    """(line, top-level package) of every absolute import in the tree,
    wherever it sits (module level, function bodies, try blocks)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_no_import_of_memex_tpu_or_jax(path):
    tree = ast.parse((ROOT / path).read_text(encoding="utf-8"), filename=path)
    bad = [(line, mod) for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_import_scan_sees_nested_imports():
    tree = ast.parse(textwrap.dedent("""
        import os
        def f():
            from memex_tpu.log import get_logger
            try:
                import jax.numpy as jnp
            except ImportError:
                pass
        from . import sibling
    """))
    assert sorted(mod for _, mod in _imported_roots(tree)) == ["jax", "memex_tpu", "os"]


_SERVE = textwrap.dedent("""
    import json, os, signal, sys, threading, time, urllib.error, urllib.request
    sys.path.insert(0, sys.argv[1])
    port, docs = int(sys.argv[2]), json.loads(sys.argv[3])
    from memex_tpu_torch import __main__ as cli

    out = {}

    def http(method, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def client():
        try:
            deadline = time.monotonic() + 120
            while True:
                try:
                    http("GET", "/api/health")
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            tasks = [http("POST", "/api/collections/c", {"content": d})["result"]["taskId"]
                     for d in docs]
            while any(http("GET", f"/api/tasks/{t}")["result"]["status"] != "Completed"
                      for t in tasks):
                time.sleep(0.1)
            out["first"] = [http("POST", "/api/collections/c/search",
                                 {"query": d, "limit": 2})["result"]["results"][0]["content"]
                            for d in docs]
            try:  # the tiny local LLM (LOCAL_LLM_CONFIG) answers: 400 unless its text is JSON
                out["ask"] = [200, http("POST", "/api/action/ask",
                                        {"text": docs[0], "query": "what?"})]
            except urllib.error.HTTPError as err:
                out["ask"] = [err.code, json.loads(err.read())]
        except Exception as exc:
            out["error"] = repr(exc)
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
    out["rc"] = cli.main(["serve", "--roles", "Api,Worker", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", str(port)])
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("memex_tpu", "jax", "jaxlib"))
    print(json.dumps(out))
""")


def test_serving_through_the_port_loads_neither_package(tmp_path):
    """`python -m memex_tpu_torch serve --device cpu`'s main() in a fresh
    interpreter: two documents ingested by the worker, each searched over
    HTTP and found first, and an ask answered by the tiny local LLM
    (LOCAL_LLM_CONFIG); then neither memex_tpu nor jax is loaded."""
    from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, save_params
    from memex_tpu_torch.text.tokenizer import _build_fallback_vocab

    model_dir = tmp_path / "model"
    vocab = _build_fallback_vocab()
    # The store's width is the settings' default (384), so the encoder is
    # MiniLM-L12's width at one layer.
    cfg = MiniLMConfig(vocab_size=len(vocab), hidden_size=384, num_layers=1, num_heads=6,
                       intermediate_size=128)
    save_params(str(model_dir), cfg, MiniLM(cfg).init_random(0), vocab=vocab)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    docs = ["alpha beta gamma delta", "the quick brown fox jumps over the lazy dog"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.pop("MEMEX_FAKE_LLM", None)
    env.pop("OPENAI_API_KEY", None)
    llm_toml = tmp_path / "llm.toml"
    llm_toml.write_text('[model]\npath = "tiny"\n')
    env.update(LOCAL_LLM_CONFIG=str(llm_toml), EMBEDDING_MODEL=str(model_dir), OMP_NUM_THREADS="2",
               DATABASE_CONNECTION=f"sqlite://{tmp_path}/memex.db",
               VECTOR_CONNECTION=f"tpu://{tmp_path}/vectors")
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(ROOT), str(port), json.dumps(docs)],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "error" not in out, (out, proc.stderr[-3000:])
    assert out["rc"] == 0
    assert out["first"] == docs
    status, body = out["ask"]
    assert status == 200 or (status == 400 and "not valid JSON" in json.dumps(body)), out["ask"]
    assert out["loaded"] == []
    assert not torch.cuda.is_initialized()
