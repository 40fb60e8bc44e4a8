"""The local-LLM cell (`dsv2lite_extract_long`) at its rehearsal size on
the CPU: the traced line carries every per-layer metric the cell lists
and the untraced one `recall_at_10` and `setup_s`; the controls and a
planted fault come out `correct: false` by the harness's own verdict,
and the controls read a lower recall; a program without the
DeepSeek-V2 family prints no result; the frozen arithmetic against hand
counts. On the card the controls run as `python3 -m perfbench.control_llm`.
"""

import json
import os
import textwrap

import pytest

from perfbench import arith_llm
from perfbench.common import Ctx, load_json
from perfbench.control_llm import control
from perfbench.run import _merge, judge, load_cell
from perfbench.tests.helpers import ROOT, rehearse

CELL = "dsv2lite_extract_long"


def test_traced_line_has_every_metric_of_the_cell():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    listed = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [CELL])}
    rc, line, err = rehearse(CELL, trace=1, seconds=3.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == listed and len(listed) == 5
    assert set(line["checks"]) == {"replay_mismatch", "worst_logit_err", "worst_choice_gap",
                                   "moe_choice_mismatch", "moe_routed_err"}
    rc, line, err = rehearse(CELL, trace=0, seconds=2.0)
    assert rc == 0, err[-3000:]
    assert set(line["metrics"]) == {"recall_at_10", "setup_s"} and line["correct"] is True


@pytest.mark.parametrize("kind", ["fp8", "top5"])
def test_controls_are_not_correct(kind, tmp_path):
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic = load_cell(bench, CELL)
    config = _merge(config, config["rehearsal"])
    traffic = _merge(traffic, traffic["rehearsal"])
    verdicts = []
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=seed, seconds=0.0,
                  trace=False, device="cpu", tmp=str(tmp_path), t_start=0.0)
        r = control(ctx, kind)
        correct, checks = judge(r, traffic["limits"])
        assert set(checks) == set(traffic["limits"]), json.dumps(checks)
        assert r["recall_at_10"] < 1.0  # the sound model reads 1.0 at this size
        verdicts.append(correct)
    assert verdicts == [False, False, False]


def test_shared_experts_dropped_is_not_correct(tmp_path):
    """The MoE layers' shared experts left out where the timed path
    computes them: the replay agrees with the timed path, the reference
    does not."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        from memex_tpu_torch.llm.local import deepseek_v2 as _d
        _orig = _d._moe
        def _moe(cfg, mp, j, h, cdt, grouped):
            B, T, H = h.shape
            shared = _d._swiglu(h.reshape(B * T, H), mp["shared_gate"][j], mp["shared_up"][j],
                                mp["shared_down"][j], cdt)
            return _orig(cfg, mp, j, h, cdt, grouped) - shared.float().view(B, T, H)
        _d._moe = _moe
    """))
    rc, line, err = rehearse(CELL, pythonpath=[str(tmp_path)], seconds=2.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["replay_mismatch"]["value"] == 0


def test_expert_ids_shifted_is_not_correct(tmp_path):
    """Every token sent to the expert after the one its router chose (the
    weights kept): the MoE tap's ids and routed sums are not the
    reference's."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent("""
        from memex_tpu_torch.llm.local import deepseek_v2 as _d
        _orig = _d.route
        def route(cfg, x, router):
            w, idx = _orig(cfg, x, router)
            return w, (idx + 1) % cfg.n_routed_experts
        _d.route = route
    """))
    rc, line, err = rehearse(CELL, pythonpath=[str(tmp_path)], seconds=2.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["moe_choice_mismatch"]["value"] > 0.9, line["checks"]
    assert line["checks"]["replay_mismatch"]["value"] == 0


def test_drawn_weights_redraw_alike_and_fill_every_parameter():
    """The harness's draw gives a tensor alike each time it is asked for,
    names every tensor the program's loader reads, and its norms are not
    all ones."""
    import torch

    from memex_tpu_torch.llm.local import deepseek_v2 as ds
    from perfbench import llm_check

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, _ = load_cell(bench, CELL)
    hf = llm_check.hf_config(_merge(config, config["rehearsal"]))
    w = llm_check.DrawnWeights(hf, 2**40 + 3, "cpu", "float32")
    name = "model.layers.2.mlp.experts.5.down_proj.weight"
    assert torch.equal(w.get(name), w.get(name))
    assert not torch.equal(w.get(name), w.get(name.replace("experts.5", "experts.6")))
    assert float(w.get("model.layers.1.input_layernorm.weight").std()) > 0.05
    read = []

    class Recording:
        def get(self, n):
            read.append(n)
            return w.get(n)

    cfg = ds.DeepseekV2Config.from_hf(hf, max_context=256, compute_dtype="float32")
    ds.load_params("unused", cfg, device="cpu", dtype="float32", tensors=Recording())
    assert sorted(read) == sorted(w.shapes)


def test_without_the_family_no_result(tmp_path):
    """As on a checkout that predates the family: `drivers/llm_ask.py`'s import
    fails, the run exits at once with no line."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['memex_tpu_torch.llm.local.deepseek_v2'] = None\n")
    rc, line, err = rehearse(CELL, pythonpath=[str(tmp_path)], seconds=2.0, timeout=120)
    assert rc != 0 and line is None, err[-2000:]


def test_token_and_decode_parameters():
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert attn == 13_762_560 and arith_llm.ATTN_PARAMS == attn
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    assert arith_llm.MOE_PARAMS == moe == 69_337_088
    assert arith_llm.TOKEN_PARAMS == 27 * attn + 3 * 2048 * 10944 + 26 * moe == 2_241_593_344
    assert arith_llm.DECODE_PARAMS == 2_241_593_344 + 2048 * 102400 == 2_451_308_544


def test_prefill_flops_by_hand():
    # Two prompts: 2 x 2.24B an id, and 27 layers x 2 x 16 x 320 x (t + 1).
    want = 0.0
    for n in (3, 5):
        want += 2.0 * 2_241_593_344 * n + 27 * 2 * 16 * 320 * sum(t + 1 for t in range(n))
    assert arith_llm.prefill_flops([3, 5]) == want
    assert arith_llm.prefill_flops([12000]) == pytest.approx(73.706e12, rel=1e-4)


def test_decode_bytes_by_hand():
    # A prompt of 100 ids and 3 steps at positions 100, 101, 102.
    want = 3 * 2_451_308_544 * 2 + 27 * 576 * 2 * (100 + 101 + 102)
    assert arith_llm.decode_bytes([(100, 3)]) == want
    assert arith_llm.decode_bytes([(100, 3), (7, 1)]) == want + 2_451_308_544 * 2 + 27 * 576 * 2 * 7


def test_readers_on_a_hand_made_window():
    from perfbench.run import reader

    obs = {"counters": {"llm.prefill_dev_us": 400_000, "llm.prefill_dev_n": 2,
                        "llm.decode_dev_us": 3_000_000, "llm.decode_tokens": 192,
                        "llm.moe_dev_us": 100_000, "llm.moe_dev_n": 52},
           "asks": [[12000, 96], [8000, 96]]}
    assert reader("prefill_ms.extract")(obs) == 200.0
    assert reader("decode_ms_per_tok.extract")(obs) == 3000.0 / 192
    assert reader("moe_share.extract")(obs) == 0.25
    assert reader("prefill_mfu.extract")(obs) == pytest.approx(
        100 * arith_llm.prefill_flops([12000, 8000]) / (0.4 * 989e12))
    assert reader("decode_hbm_share.extract")(obs) == pytest.approx(
        100 * arith_llm.decode_bytes([[12000, 96], [8000, 96]]) / (3.0 * 3.35e12))
    for name in ("prefill_ms.extract", "decode_ms_per_tok.extract", "moe_share.extract",
                 "prefill_mfu.extract", "decode_hbm_share.extract"):
        assert reader(name)({"counters": {}, "asks": []}) is None
        assert reader(name)({}) is None
