"""The controls (int4 rows in the program's place) come out not correct
by the harness's own verdict (`run.judge` under each cell's limits) at the
rehearsal size on the CPU, while the program's own run passes them
(test_perfbench_harness); on the card the same comparison is made at the
cell's size with `python3 -m perfbench.control`."""

import json
import os

import pytest

from perfbench.common import Ctx, load_json
from perfbench.control import ingest_control, search_control
from perfbench.run import _merge, judge, load_cell
from perfbench.tests.helpers import ROOT

CELLS = [w["name"] for w in load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, tmp_path):
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    c, config, traffic = load_cell(bench, cell)
    config = _merge(config, config.get("rehearsal", {}))
    traffic = _merge(traffic, traffic.get("rehearsal", {}))
    verdicts = []
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ctx = Ctx(cell=c, config=config, traffic=traffic, seed=seed, seconds=0.0, trace=False,
                  device="cpu", tmp=str(tmp_path), t_start=0.0)
        r = (ingest_control if traffic["kind"] == "ingest_backlog" else search_control)(ctx)
        correct, checks = judge(r, traffic["limits"])
        assert set(checks) == set(traffic["limits"]) and all(
            r.get(name) is not None for name in traffic["limits"]), json.dumps(checks)
        verdicts.append(correct)
    assert verdicts == [False, False, False], json.dumps(traffic["limits"])
