"""The flat-tier sweeps (memex_tpu_torch/benchmarks/{keep2_validate,
int4_refine_sweep,int4_bank_sweep,int4_bank_sweep2}.py) against memex_tpu's
root benchmarks/ scripts, on the CPU at 8,192 x 384.

memex_tpu's scripts run at import and draw with jax.random, so each is
rebuilt here from its source: the same functions with the same arguments
(Pallas in interpret mode), on the port's draws of the rows and queries
(bench_kernels' seeds), carried across as numpy. block_n (the TPU kernels'
row tile) is capped at the rows present, as tests/test_torch_bench.py
does: N must be a multiple of it there, and it changes no result (it caps
banks at block_n / 128 = 64, above every bank count here).

Each sweep's rows must carry the script's keys in its order of variants,
and each variant's recall@10 (the int8 and int4 banks are exact integer
dots, bit-equal to memex_tpu's kernels; the rerank is float32) must equal
memex_tpu's; int4_bank_sweep2's misses are the same (query, row) pairs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.index.flat import _exact_flat_rerank as j_rerank
from memex_tpu.index.flat import _search_rerank_fused as j_fused
from memex_tpu.ops import fused_topk as jft
from memex_tpu.ops.topk import score_topk as j_score_topk
from memex_tpu_torch import bench
from memex_tpu_torch.benchmarks import (flat_sweep, int4_bank_sweep, int4_bank_sweep2,
                                        int4_refine_sweep, keep2_validate)

torch.set_num_threads(2)

N, Q, K = 8192, 32, 10
TIMED_KEYS = ["variant", "qps", "p50_batch_ms", "recall_at_10"]


def bn(block_n):
    return min(block_n, N)


@pytest.fixture(scope="module")
def jax_case():
    """memex_tpu's operands and oracle on the port's draws."""
    db = jnp.asarray(bench.kernel_rows("cpu", N).numpy())
    q = jnp.asarray(bench._randn(2, (Q, 384), torch.device("cpu")).numpy())
    db8, scales, rq8, rsc2 = jft.quantize_rows_int8_refine(db)
    db4t, _ = jft.quantize_rows_int4(db)
    _, ei = j_score_topk(db, q, K, method="exact_f32")
    return dict(db8=db8, scales=scales, rq8=rq8, rsc2=rsc2, db4t=db4t, q=q, ei=np.asarray(ei))


def recall(c, ids) -> float:
    fi = np.asarray(ids)[:Q]
    return float(np.mean([len(set(fi[i]) & set(c["ei"][i])) / K for i in range(Q)]))


def run_port(mod):
    return mod.main("cpu", N, batches=2, reps=1)


def test_keep2_validate_matches_memex_tpus_script(jax_case):
    c = jax_case

    def i8(keep2):
        return j_fused(c["db8"], c["scales"], None, c["rq8"], c["rsc2"], None, N, c["q"], K,
                       64, 64, bn(8192), True, False, "int8", True, False, 16, keep2)

    def i4(banks4, keep2):
        return j_fused(c["db4t"], c["scales"], c["db8"], c["rq8"], c["rsc2"], None, N, c["q"],
                       K, 64, 128, bn(32768), True, True, "int4", True, False, banks4, keep2)

    want = [("int8q_refine_keep1", i8(False)), ("int8q_refine_keep2", i8(True)),
            ("int4_refine_b8_keep1", i4(8, False)), ("int4_refine_b16_keep1", i4(16, False)),
            ("int4_refine_b16_keep2", i4(16, True)), ("int4_refine_b8_keep2", i4(8, True))]
    rows = run_port(keep2_validate)
    assert [r["variant"] for r in rows] == [name for name, _ in want]
    for row, (name, out) in zip(rows, want):
        assert list(row) == TIMED_KEYS + ["compile_s"]
        assert row["recall_at_10"] == round(recall(c, out[1]), 4), name


def test_int4_refine_sweep_matches_memex_tpus_script(jax_case, capsys):
    c = jax_case
    want = []
    for kk, kret in int4_refine_sweep.INT4_GRID:
        want.append((f"int4_refine_kk{kk}_ret{kret}", j_fused(
            c["db4t"], c["scales"], c["db8"], c["rq8"], c["rsc2"], None, N, c["q"], K, kret,
            kk, bn(32768), True, True, "int4", True, False)))
    for kk, kret in int4_refine_sweep.INT8Q_GRID:
        want.append((f"int8q_refine_kk{kk}_ret{kret}", j_fused(
            c["db8"], c["scales"], None, c["rq8"], c["rsc2"], None, N, c["q"], K, kret, kk,
            bn(8192), True, False, "int8", True, False)))
    rows = run_port(int4_refine_sweep)
    assert [r["variant"] for r in rows] == [name for name, _ in want]
    for row, (name, out) in zip(rows, want):
        assert list(row) == TIMED_KEYS
        assert row["recall_at_10"] == round(recall(c, out[1]), 4), name
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"sweep": rows}


def test_int4_bank_sweep_matches_memex_tpus_script(jax_case, capsys):
    c = jax_case
    want = []
    for name, banks, deferred in int4_bank_sweep.VARIANTS:
        vals, idx = jft.fused_score_topk_int4_rerank(
            c["db4t"], c["scales"], c["db8"], c["q"], 64, count=N, rerank=128,
            block_n=bn(32768), banks=banks, deferred=deferred, interpret=True)
        want.append((name, j_rerank(c["db8"], c["scales"], c["q"], vals, idx, K,
                                    rbuf=c["rq8"], rbuf_scales=c["rsc2"])))
    assert [v[0] for v in int4_bank_sweep.VARIANTS] == [
        "b8_deferred", "b8_exact_unpack", "b16_deferred", "b16_exact_unpack"]
    rows = run_port(int4_bank_sweep)
    assert [r["variant"] for r in rows] == [name for name, _ in want]
    for row, (name, out) in zip(rows, want):
        assert list(row) == TIMED_KEYS + ["compile_s"]
        assert row["recall_at_10"] == round(recall(c, out[1]), 4), name
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"sweep": rows}


def test_int4_bank_sweep2_matches_memex_tpus_script(jax_case):
    c = jax_case
    lost = {}
    for name, kind, banks in int4_bank_sweep2.VARIANTS:
        if kind == "int4":
            vals, idx = jft.fused_score_topk_int4_rerank(
                c["db4t"], c["scales"], c["db8"], c["q"], 64, count=N, rerank=128,
                block_n=bn(32768), banks=banks, deferred=True, interpret=True)
        else:
            vals, idx = jft.fused_score_topk_int8q(c["db8"], c["scales"], c["q"], 64, count=N,
                                                   block_n=8192, banks=banks, interpret=True)
        fi = np.asarray(j_rerank(c["db8"], c["scales"], c["q"], vals, idx, K, rbuf=c["rq8"],
                                 rbuf_scales=c["rsc2"])[1])[:Q]
        lost[name] = {(qi, int(r)) for qi in range(Q) for r in set(c["ei"][qi]) - set(fi[qi])}
    out = int4_bank_sweep2.main("cpu", N)
    assert list(out["gaps"]) == ["min_boundary_gap", "median_boundary_gap"]
    assert 0 <= out["gaps"]["min_boundary_gap"] <= out["gaps"]["median_boundary_gap"]
    assert [v["variant"] for v in out["variants"]] == list(lost)
    for row in out["variants"]:
        assert list(row) == ["variant", "recall", "misses"]
        assert {tuple(m) for m in row["misses"]} == lost[row["variant"]]
        assert row["recall"] == round(1.0 - len(lost[row["variant"]]) / (Q * K), 4)
    assert list(out["summary"]) == ["common_int8q_b4_int4_b16", "union_sizes", "elapsed_s"]
    assert out["summary"]["union_sizes"] == [len(m) for m in lost.values()]
    assert ({tuple(m) for m in out["summary"]["common_int8q_b4_int4_b16"]}
            == lost["int8q_b4"] & lost["int4_b16"])


def test_sweep_case_draws_bench_kernels_corpus_and_oracle():
    """Rows from seed 0 (bench_kernels'), the oracle on the queries of seed
    2, which are the chain's first batch; the gaps are the oracle's
    10th-best minus 11th-best scores."""
    c = flat_sweep.make_case("cpu", 4096, batches=3)
    db = bench.kernel_rows("cpu", 4096)
    assert torch.equal(c.qs[0], c.oracle_q) and len(c.qs) == 3
    assert torch.equal(c.qs[2], bench._randn(4, (Q, 384), torch.device("cpu")))
    s = (c.oracle_q.double() @ db.double().T).numpy()
    top = np.sort(s, axis=1)[:, ::-1]
    np.testing.assert_allclose(c.gaps, top[:, K - 1] - top[:, K], rtol=0, atol=1e-5)
    assert flat_sweep.recall(c, torch.from_numpy(c.ei)) == 1.0


@pytest.mark.parametrize("mod", [keep2_validate, int4_refine_sweep, int4_bank_sweep,
                                 int4_bank_sweep2])
def test_sweep_cli_refuses_cuda_without_a_card(mod, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name = mod.__name__.rsplit(".", 1)[-1]
    assert flat_sweep.cli(mod.main, name, []) == 2
    assert capsys.readouterr().out == ""  # no row
