"""The port's CLI (`python -m memex_tpu_torch`): the counterparts of
tests/test_cli.py for serve, migrate and load, and the train and
download-model commands, all on the CPU (`--device cpu`)."""

import json

import numpy as np
import pytest
import torch

from memex_tpu_torch import __main__ as cli
from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, load_params, save_params
from memex_tpu_torch.text.tokenizer import _build_fallback_vocab

COMMANDS = ("serve", "migrate", "train", "load", "download-model")


@pytest.fixture
def env(tmp_path, monkeypatch):
    """A tiny encoder checkpoint, a SQLite file and an in-memory vector
    store for the commands' TorchRuntime; the cwd is the test's own."""
    model_dir = tmp_path / "model"
    vocab = _build_fallback_vocab()
    cfg = MiniLMConfig(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=2,
                       intermediate_size=64)
    save_params(str(model_dir), cfg, MiniLM(cfg).init_random(0), vocab=vocab)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EMBEDDING_MODEL", str(model_dir))
    monkeypatch.setenv("DATABASE_CONNECTION", f"sqlite://{tmp_path}/cli.db")
    monkeypatch.setenv("VECTOR_CONNECTION", "memory://")
    return tmp_path


def _queue_count(db_file, collection) -> int:
    from memex_tpu_torch.db.connection import create_connection_by_uri

    db = create_connection_by_uri(f"sqlite://{db_file}")
    return db.query_one("SELECT COUNT(*) AS n FROM queue WHERE collection = ?",
                        (collection,))["n"]


@pytest.mark.parametrize("command", COMMANDS)
def test_every_command_is_there(command, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([command, "--help"])
    assert exc.value.code == 0
    assert f"memex_tpu_torch {command}" in capsys.readouterr().out


def test_migrate_command(tmp_path):
    db = tmp_path / "mig.db"
    assert cli.main(["migrate", "--database-connection", f"sqlite://{db}"]) == 0
    assert db.exists()
    assert cli.main(["migrate", "--database-connection", f"sqlite://{db}"]) == 0


def test_serve_rejects_bad_roles(env):
    assert cli.main(["serve", "--roles", "Bogus", "--device", "cpu"]) == 2


def test_load_command(env):
    docs = env / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text("first document about foxes")
    (docs / "b.txt").write_text("second document about dogs")
    (docs / "empty.txt").write_text("  \n")
    assert cli.main(["load", "docs", str(docs), "--device", "cpu"]) == 0
    assert _queue_count(env / "cli.db", "docs") == 2


@pytest.mark.parametrize("command", ["train", "load"])
def test_train_and_load_refuse_cuda_without_a_card(env, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"train": ["train", "c"], "load": ["load", "c", str(env)]}[command]
    assert cli.main(args) == 2
    assert cli.main(args + ["--device", "cuda"]) == 2


def test_load_wait_then_train_exports_and_prints_metrics(env, capsys):
    """load --wait ingests through the port's worker; train fine-tunes on
    the adjacent windows, writes its checkpoint and export, prints its
    metrics as the last stdout line, and --resume advances the step."""
    doc = env / "doc.txt"
    doc.write_text("alpha beta gamma delta epsilon zeta eta theta " * 40)
    assert cli.main(["load", "traincol", str(doc), "--wait", "--timeout", "120",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    out, ckpt = env / "ft", env / "st.npz"
    assert cli.main(["train", "traincol", "--out", str(out), "--checkpoint", str(ckpt),
                     "--device", "cpu", "--learning-rate", "1e-4"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m["pairs"] > 1 and m["step"] == 1 and np.isfinite(m["loss"])
    assert 0.0 <= m["accuracy"] <= 1.0
    cfg, model = load_params(str(out))
    assert cfg.hidden_size == 32 and (out / "vocab.txt").exists()
    # The serving engine's dense weights are bf16: training starts from them.
    _, before = load_params(str(env / "model"))
    start = before.layers[0].ffn_in.weight.bfloat16().float()
    assert not torch.equal(model.layers[0].ffn_in.weight, start)
    assert cli.main(["train", "traincol", "--resume", str(ckpt), "--device", "cpu"]) == 0
    m2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert m2["step"] == 2 and m2["pairs"] == m["pairs"]


def test_load_wait_past_its_timeout_exits_1_and_stops_the_worker(env, monkeypatch):
    """A deliberate departure from memex_tpu, whose `load --wait` exits 0
    whatever the drain returned: a queue not drained by --timeout exits 1,
    and the worker is shut down (its scheduler flag set, its pool closed)
    with the task still queued."""
    from memex_tpu_torch.worker import Worker

    stopped = []
    shutdown = Worker.shutdown

    def record(self, wait=True):
        stopped.append(self)
        shutdown(self, wait)

    monkeypatch.setattr(Worker, "shutdown", record)
    doc = env / "doc.txt"
    doc.write_text("a document the worker never reaches")
    assert cli.main(["load", "late", str(doc), "--wait", "--timeout", "0",
                     "--device", "cpu"]) == 1
    assert len(stopped) == 1
    assert stopped[0]._shutdown.is_set() and stopped[0]._pool._shutdown
    assert _queue_count(env / "cli.db", "late") == 1


def test_download_model_with_the_files_present(tmp_path):
    target = tmp_path / "m"
    target.mkdir()
    for name in ("model.safetensors", "config.json", "vocab.txt"):
        (target / name).write_text("x")
    assert cli.main(["download-model", "--target", str(target)]) == 0
