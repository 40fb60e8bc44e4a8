"""The port's clippy client (memex_tpu_torch/clippy.py) against a live port
server in this process: tests/test_clippy.py's load / ask / qq / forget,
then `--local-llm` on the CPU. Under greedy decoding its streamed answer
must equal memex_tpu's examples/clippy.py on the same weights (a seeded
2-layer HF llama checkpoint both packages load, as tests/test_torch_llm.py
does), asked against the same server: the HTTP modes talk to either
server unchanged.
"""

import asyncio
import contextlib
import io
import socket
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from memex_tpu_torch import clippy
from memex_tpu_torch.api.server import start_async
from memex_tpu_torch.config import Settings
from memex_tpu_torch.llm.base import ChatMessage, ChatRole
from memex_tpu_torch.runtime import TorchRuntime
from memex_tpu_torch.worker import Worker
from test_torch_engine import jax_params, model_dir, port_engine  # noqa: F401
from test_torch_llm import hf_llama_dir, write_toml

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
QUESTION = "where are vectors stored?"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def live_server(tmp_path_factory, model_dir):  # noqa: F811
    tmp = tmp_path_factory.mktemp("clippy")
    port = free_port()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEMEX_FAKE_LLM", "1")
        mp.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
        settings = Settings.from_env(host="127.0.0.1", port=port, db_uri=f"sqlite://{tmp}/c.db",
                                     vector_uri="memory://", embedding_model="random")
        settings.embedding_dim = 64
        rt = TorchRuntime(settings, device="cpu")
        rt._engine = port_engine(model_dir, 32)
        worker = Worker(rt, poll_interval=0.01)
        worker.start_background()
        loop = asyncio.new_event_loop()
        stop = asyncio.Event()

        def run_server():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(start_async(rt, stop))

        thread = threading.Thread(target=run_server, daemon=True)
        thread.start()
        host = f"http://127.0.0.1:{port}"
        for _ in range(100):
            try:
                clippy._checked("GET", f"{host}/api/health", timeout=1)
                break
            except OSError:
                time.sleep(0.1)
        else:
            pytest.fail("server did not start")
        yield host
        loop.call_soon_threadsafe(stop.set)
        worker.shutdown(wait=False)
        thread.join(timeout=5)
        rt.search_batcher.close()


def test_load_ask_qq_forget(live_server, tmp_path, capsys):
    doc = tmp_path / "doc.txt"
    doc.write_text("The memex_tpu project stores vectors on TPU. "
                   "Retrieval runs a fused Pallas kernel. " * 3)
    assert clippy.main(["--host", live_server, "load-file", str(doc)]) == 0
    assert "ingest completed" in capsys.readouterr().out

    assert clippy.main(["--host", live_server, "ask", QUESTION]) == 0
    assert "context segments" in capsys.readouterr().out

    assert clippy.main(["--host", live_server, "qq", "quick question"]) == 0

    assert clippy.main(["--host", live_server, "forget"]) == 0
    assert "deleted" in capsys.readouterr().out


def test_unreachable_service_exits_1(capsys):
    with pytest.raises(SystemExit) as exc:
        clippy.main(["--host", f"http://127.0.0.1:{free_port()}", "forget"])
    assert exc.value.code == 1
    assert "not reachable" in capsys.readouterr().err


def test_local_llm_without_a_card_exits_2(monkeypatch, tmp_path, capsys):
    """No fallback to the CPU: --device defaults to cuda."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toml = write_toml(tmp_path, '[model]\npath = "tiny"\n')
    assert clippy.main(["--local-llm", toml, "qq", "x"]) == 2
    assert capsys.readouterr().out == ""


def _answer(out: str) -> str:
    """The streamed answer: stdout up to the ask's closing status line."""
    return out.rsplit("\n[", 1)[0]


# bf16 compute: each package's logits are a few bf16 ulps from the other's
# (tests/test_torch_llm.py's BF16_TOL), so two candidates closer than twice
# that may be ranked either way by greedy decoding.
TIE = 2 * 2e-2


def _recording(llm) -> dict:
    """Record the LLM's last prompt and the ids of its last full decode."""
    box: dict = {"ids": []}
    decode, chat = llm.tokenizer.decode, llm.chat_completion

    def recording_decode(ids):
        ids = [int(t) for t in ids]
        if len(ids) >= len(box["ids"]):
            box["ids"] = ids
        return decode(ids)

    def recording_chat(model, messages, **kw):
        box["prompt"], box["ids"] = messages[-1].content, []
        return chat(model, messages, **kw)

    llm.tokenizer.decode, llm.chat_completion = recording_decode, recording_chat
    return box


def _greedy_flip_is_a_tie(jllm, prompt_ids: list, ids: list, i: int, got: int) -> float:
    """memex_tpu's penalized logits at step i of its own answer `ids`: the
    port's token `got` must be one of its top two, within TIE of the
    first. Returns the gap."""
    import jax.numpy as jnp
    import numpy as np

    from memex_tpu.llm.local import model as jm

    seq = prompt_ids + ids[:i]
    logits, _ = jm.model_forward(jllm.cfg, jllm.params, jnp.asarray([seq], jnp.int32),
                                 jnp.arange(len(seq))[None], jm.init_cache(jllm.cfg), 0)
    last = np.asarray(logits[0, -1], np.float32)
    sc = jllm.sampler
    seen = np.zeros(last.shape, bool)
    seen[seq[-sc.repetition_window:]] = True
    last = np.where(seen, np.where(last > 0, last / sc.repetition_penalty,
                                   last * sc.repetition_penalty), last)
    top = np.argsort(-last, kind="stable")[:2]
    assert top[0] == ids[i] and got == top[1], (i, top, ids[i], got)
    gap = float(last[top[0]] - last[top[1]])
    assert gap <= TIE, (i, gap)
    return gap


def test_local_llm_streams_memex_tpus_greedy_answer(live_server, tmp_path):
    """The port's streamed answer, token by token as it is printed, is
    memex_tpu's clippy's on the same weights and context, up to the first
    step where the two rank a near-tie apart; there the port's token must
    be memex_tpu's second choice within TIE of its first."""
    transformers = pytest.importorskip("transformers")
    from memex_tpu.llm.local import runtime as jrt
    from memex_tpu_torch.llm.local import runtime as trt

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import clippy as jclippy
    finally:
        sys.path.remove(str(ROOT / "examples"))
    toml = write_toml(tmp_path, f'[model]\npath = "{hf_llama_dir(tmp_path / "m", transformers)}"'
                                '\nparam_dtype = "float32"\n[sampler]\ntemperature = 0.0\n')
    doc = tmp_path / "doc.txt"
    doc.write_text("Vectors are stored in device memory, one int8 row per window. " * 4)
    assert clippy.main(["--host", live_server, "load-file", str(doc)]) == 0

    local = clippy.LocalAnswerer(toml, "cpu")
    local._llm = trt.LocalLLM.from_config(toml, device="cpu")
    jclippy._LOCAL_LLM = jllm = jrt.LocalLLM.from_config(toml)
    boxes = [_recording(local._llm), _recording(jllm)]
    outs = []
    try:
        for run in (
            lambda: clippy.main(["--host", live_server, "--local-llm", toml, "--device", "cpu",
                                 "ask", QUESTION], local=local),
            lambda: jclippy.main(["--host", live_server, "--local-llm", toml, "ask", QUESTION]),
        ):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run() == 0
            outs.append(buf.getvalue())
    finally:
        jclippy._LOCAL_LLM = None
    port_out, jax_out = outs
    (mine, theirs) = boxes
    assert "[2 context segments" in port_out.splitlines()[-1]
    assert mine["prompt"] == theirs["prompt"] and QUESTION in mine["prompt"]
    pieces = local.last["pieces"]
    assert len(pieces) > 1  # streamed, not printed at the end
    assert _answer(port_out) == "".join(pieces) == local._llm.tokenizer.decode(mine["ids"])
    assert _answer(jax_out) == jllm.tokenizer.decode(theirs["ids"])
    a, b = mine["ids"], theirs["ids"]
    split = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), None)
    if split is None:
        assert a == b and _answer(port_out) == _answer(jax_out)
    else:
        padded, n, _ = local._llm.encode_prompt([ChatMessage(ChatRole.User, mine["prompt"])],
                                                None)
        _greedy_flip_is_a_tie(jllm, padded[0, :n].tolist(), b, split, a[split])
    assert local.last["tokens"] == len(mine["ids"])
    assert (local.last["first_token_ms"] <= local.last["first_piece_ms"]
            <= local.last["total_ms"])

    # The loaded model serves the next command; qq streams the same way.
    model = local._llm
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert clippy.main(["--host", live_server, "--local-llm", toml, "--device", "cpu", "qq",
                            "hello"], local=local) == 0
    assert local._llm is model and buf.getvalue() == "".join(local.last["pieces"])
    assert clippy.main(["--host", live_server, "forget"]) == 0
