"""On the card: one short run of each cell through the command the
driver uses, correct and with the contract's device keys. Skips without
a card (decided inside the test).

    python3 -m pytest -m gpu perfbench/tests/test_perfbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from perfbench.common import load_json
from perfbench.tests.helpers import ROOT

CELLS = [w["name"] for w in load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell, "--seed",
                           str(2**31 + 77), "--seconds", "5", "--trace", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert all(isinstance(m["value"], float) for m in line["metrics"].values())
