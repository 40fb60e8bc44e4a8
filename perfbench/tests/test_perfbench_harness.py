"""The harness as data: a cell, a traffic file and a metric reader added
in a copy are found and run with no edit of an existing file; the result
line's keys; a run outside a checkout of the repository prints nothing."""

import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.helpers import ROOT, rehearse

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_result_line_keys_untraced():
    rc, line, err = rehearse("ivf10m_search_sat", trace=0, seconds=5.0)
    assert rc == 0, err[-3000:]
    assert LINE_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"recall_at_10", "setup_s"}
    assert all(m["value"] == "not measured" for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert err.rstrip().splitlines()[-1].startswith("check worst_gap:")


def test_added_cell_traffic_and_reader_need_no_edit(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(os.path.join(ROOT, "perfbench"), copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in _files(copy / "perfbench")}
    traffic = json.load(open(copy / "perfbench" / "traffic" / "ivf10m_search_sat.json"))
    traffic["clients"] = 16
    json.dump(traffic, open(copy / "perfbench" / "traffic" / "flat1m_search_small.json", "w"))
    (copy / "perfbench" / "layer_metrics" / "batches.sat.py").write_text(
        "def read(obs):\n    return float(obs['counters']['batcher.search.batches'])\n")
    bench["workloads"].append({"name": "flat1m_search_small", "config": "minilm12-flat-int8q-1M",
                               "traffic": "flat1m_search_small", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "batches.sat", "unit": "batches", "better": "lower",
                               "source": "program_counter", "layer": "serve/batcher.py",
                               "moves": "recall_at_10", "workloads": ["flat1m_search_small"]})
    json.dump(bench, open(copy / "BENCHMARK.json", "w"))
    rc, line, err = rehearse("flat1m_search_small", trace=1, cwd=str(copy))
    assert rc == 0, err[-3000:]
    # The new reader runs; a metric whose `workloads` omits the new cell does not.
    assert "batches.sat" in line["metrics"] and "probed_rows.ivf" not in line["metrics"]
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


def test_no_result_outside_a_checkout(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                           "ivf10m_search_sat", "--seed", "1", "--seconds", "1", "--trace", "0",
                           "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_no_card_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                           "ivf10m_search_sat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and not proc.stdout.strip()


def _files(d):
    for base, _, files in os.walk(d):
        for f in files:
            if "__pycache__" not in base:
                yield os.path.join(base, f)
