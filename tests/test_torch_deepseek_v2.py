"""The port's DeepSeek-V2 family (memex_tpu_torch/llm/local/deepseek_v2.py)
against the benchmark's plain float32 reference (perfbench/reference/
deepseek_v2.py) and transformers' DeepseekV2, at a tiny size in float32
on seeded weights, on the CPU.

Tolerances:
- TOL (the port in float32 against the float32 reference, and the
  absorbed decode path against the expanded prefill path): both sum the
  same float32 products in other orders (SDPA against blocked einsums,
  W_UK absorbed into the query against K expanded from the latent); a few
  float32 ulps of logits below 4, 2.4e-7 measured; 1e-5 leaves a margin
  of ~40x and lies far below the 0.1 weight scale any fault moves.
- HF_TOL (against transformers' DeepseekV2ForCausalLM, weights scaled to
  0.1 so that every layer matters): 1.9e-6 measured on logits up to ~4.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from memex_tpu_torch.llm.base import ChatMessage, ChatRole
from memex_tpu_torch.llm.local import deepseek_v2 as ds
from memex_tpu_torch.llm.local import model as tm
from memex_tpu_torch.llm.local import runtime as trt
from memex_tpu_torch.metrics import Metrics
from perfbench.reference import deepseek_v2 as ref

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-5
HF_TOL = 2e-5

# A tiny DeepSeek-V2 with every mechanism of the published one: one dense
# layer then MoE layers, YaRN at factor 40 over 64 original positions (so
# that the ramp blends), v_head_dim unlike the query's nope width.
HF = {
    "model_type": "deepseek_v2", "vocab_size": 300, "hidden_size": 64,
    "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 12, "kv_lora_rank": 32,
    "q_lora_rank": None, "intermediate_size": 96, "moe_intermediate_size": 24,
    "n_routed_experts": 8, "n_shared_experts": 2, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "norm_topk_prob": False, "routed_scaling_factor": 1.0,
    "topk_method": "greedy", "scoring_func": "softmax", "moe_layer_freq": 1,
    "rope_theta": 10000.0, "max_position_embeddings": 2560, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
}


def tiny(hf=HF, max_context=128):
    cfg = ds.DeepseekV2Config.from_hf(hf, max_context=max_context, compute_dtype="float32")
    params = ds.init_params(cfg, seed=7, device=CPU, dtype="float32")
    # 0.1-scale weights and varied norms, so that every layer and every
    # expert moves the logits (0.02 leaves a tiny model nearly linear).
    g = torch.Generator().manual_seed(11)
    for group in ("layers", "dense", "moe"):
        for k, v in params[group].items():
            if "norm" in k:
                v.copy_(torch.rand(v.shape, generator=g) + 0.5)
            else:
                v.mul_(5.0)
    params["lm_head"].mul_(5.0)
    return cfg, params


def ids_of(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 300, (1, n))).long()


def test_prefill_then_latent_decode_match_the_reference():
    cfg, p = tiny()
    ids = ids_of(40)
    T = 28
    want = ref.logits(HF, hf_tensors(cfg, p).__getitem__, ids[0].tolist(), list(range(40)))
    cache = tm.init_cache(cfg, device=CPU)
    assert cache["latent"].shape == (3, 1, 128, 32 + 8)
    got, cache = tm.model_forward(cfg, p, ids[:, :T], torch.arange(T)[None], cache, 0)
    np.testing.assert_allclose(got[0].numpy(), want[:T].numpy(), atol=TOL, rtol=0)
    for t in range(T, 40):
        pos = torch.tensor(t)
        step, cache = tm.model_forward(cfg, p, ids[:, t:t + 1], pos.view(1, 1), cache, pos)
        np.testing.assert_allclose(step[0, 0].numpy(), want[t].numpy(), atol=TOL, rtol=0)
    assert float(want.std()) > 0.5  # the comparison is not of near-zero logits


def test_absorbed_decode_matches_expanded_prefill():
    """Token by token through the latent cache from position 0 (decode
    path: W_UK absorbed, W_UV after) against one prefill (K and V
    expanded, SDPA) over the same ids."""
    cfg, p = tiny()
    ids = ids_of(24, seed=1)
    full, pcache = tm.model_forward(cfg, p, ids, torch.arange(24)[None],
                                    tm.init_cache(cfg, device=CPU), 0)
    cache = tm.init_cache(cfg, device=CPU)
    for t in range(24):
        pos = torch.tensor(t)
        step, cache = tm.model_forward(cfg, p, ids[:, t:t + 1], pos.view(1, 1), cache, pos)
        np.testing.assert_allclose(step[0, 0].numpy(), full[0, t].numpy(), atol=TOL, rtol=0)
    # Both paths wrote the same latent rows.
    torch.testing.assert_close(cache["latent"][:, :, :24], pcache["latent"][:, :, :24],
                               atol=TOL, rtol=0)
    at, _ = tm.model_forward(cfg, p, ids, torch.arange(24)[None], tm.init_cache(cfg, device=CPU),
                             0, logits_at=17)
    assert at.shape == (1, 1, 300)
    np.testing.assert_allclose(at[0, 0].numpy(), full[0, 17].numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("family", ["deepseek_v2", "llama"])
def test_logits_at_a_tensor_of_rows(family):
    """`logits_at` given a 1-D tensor of rows gives the full logits at
    those rows, in their order, for the family that computes the head
    there alone and for one that slices its full logits."""
    if family == "deepseek_v2":
        cfg, p = tiny()
    else:
        cfg = tm.LlamaConfig.tiny()
        p = tm.init_params(cfg, seed=3, device=CPU)
    ids = ids_of(24, seed=2) % cfg.vocab_size
    full, _ = tm.model_forward(cfg, p, ids, torch.arange(24)[None],
                               tm.init_cache(cfg, device=CPU), 0)
    rows = torch.tensor([0, 5, 23, 11])
    at, _ = tm.model_forward(cfg, p, ids, torch.arange(24)[None], tm.init_cache(cfg, device=CPU),
                             0, logits_at=rows)
    assert at.shape == (1, 4, full.shape[-1])
    np.testing.assert_allclose(at[0].numpy(), full[0, rows].numpy(), atol=TOL, rtol=0)


def test_yarn_tables_match_the_formula():
    """DeepSeek-V2-Lite's published rope_scaling: inv_freq from the
    formula in float64, the cos/sin scale 1 and the softmax scale
    192^-0.5 * (0.1 * 0.707 * ln 40 + 1)^2."""
    pub = dict(HF, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
               rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                             "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                             "mscale_all_dim": 0.707})
    cfg = ds.DeepseekV2Config.from_hf(pub, max_context=32768)
    dim, base = 64, 10000.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert (low, high) == ds.yarn_find_correction_range(32, 1, 64, 10000, 4096) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = base ** (-2 * i / dim)
        keep = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * (1 - keep) + extra * keep)
    got = ds.yarn_inv_freq(cfg).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 1.0 and got[-1] == pytest.approx(base ** (-62 / 64) / 40, rel=1e-6)
    np.testing.assert_array_equal(ref.inv_freq(pub).numpy(), ds.yarn_inv_freq(cfg).numpy())
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert cfg.rope_mscale == 1.0 and ref.scales(pub) == (pytest.approx(cfg.softmax_scale), 1.0)
    cos, sin = ds.rope_tables(cfg, torch.tensor([[0, 1, 31999]]))
    angles = torch.tensor([0.0, 1.0, 31999.0])[:, None] * ds.yarn_inv_freq(cfg)
    torch.testing.assert_close(cos[0, :, 0], torch.cos(angles))
    torch.testing.assert_close(sin[0, :, 0], torch.sin(angles))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("grouped", [False, True])
def test_routing_is_greedy_top_k_with_shared_experts_once(norm, grouped):
    """The MoE layer against a loop written here: a float32 softmax over
    every expert, the top k kept (weights renormalised only with
    norm_topk_prob, else times routed_scaling_factor), each chosen
    expert's SwiGLU, plus the shared experts once. Both the grouped
    (prefill) and the gathered (decode) paths."""
    cfg, p = tiny()
    cfg = dataclasses.replace(cfg, norm_topk_prob=norm, routed_scaling_factor=1.5)
    mp = p["moe"]
    h = torch.randn(1, 9, 64, generator=torch.Generator().manual_seed(3))
    got = ds._moe(cfg, mp, 1, h, torch.float32, grouped=grouped)

    def swiglu(x, g, u, d):
        return (torch.nn.functional.silu(x @ g) * (x @ u)) @ d

    for t in range(9):
        x = h[0, t]
        probs = torch.softmax(x @ mp["router"][1], dim=-1)
        top = sorted(range(8), key=lambda e: -float(probs[e]))[:3]
        w = probs[top]
        w = w / w.sum() if norm else w * 1.5
        routed = sum(w[i] * swiglu(x, mp["gate"][1, e], mp["up"][1, e], mp["down"][1, e])
                     for i, e in enumerate(top))
        shared = swiglu(x, mp["shared_gate"][1], mp["shared_up"][1], mp["shared_down"][1])
        torch.testing.assert_close(got[0, t], routed + shared, atol=1e-5, rtol=1e-5)
    if not norm:  # no renormalisation: the kept weights sum below the scaling factor
        w, _ = ds.route(cfg, h[0], mp["router"][1])
        assert bool((w.sum(-1) < 1.5).all())


def hf_tensors(cfg, p):
    """The port's parameters under HF's DeepSeek-V2 names ([out, in])."""
    out = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm"],
           "lm_head.weight": p["lm_head"].T}
    names = {"attn_norm": "input_layernorm.weight", "q": "self_attn.q_proj.weight",
             "kv_a": "self_attn.kv_a_proj_with_mqa.weight",
             "kv_norm": "self_attn.kv_a_layernorm.weight", "kv_b": "self_attn.kv_b_proj.weight",
             "o": "self_attn.o_proj.weight", "ffn_norm": "post_attention_layernorm.weight"}
    mlp = {"gate": "gate_proj.weight", "up": "up_proj.weight", "down": "down_proj.weight"}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        for k, hf in names.items():
            w = p["layers"][k][i]
            out[pre + hf] = w.T if w.dim() == 2 else w
        if i < cfg.first_k_dense_replace:
            for k, hf in mlp.items():
                out[pre + "mlp." + hf] = p["dense"][k][i].T
            continue
        j = i - cfg.first_k_dense_replace
        out[pre + "mlp.gate.weight"] = p["moe"]["router"][j].T
        for k, hf in mlp.items():
            out[pre + "mlp.shared_experts." + hf] = p["moe"]["shared_" + k][j].T
            for e in range(cfg.n_routed_experts):
                out[pre + f"mlp.experts.{e}.{hf}"] = p["moe"][k][j, e].T
    return {k: v.contiguous() for k, v in out.items()}


class _InMemory:
    def __init__(self, tensors):
        self.tensors, self.read = tensors, []

    def get(self, name):
        self.read.append(name)
        return self.tensors[name]


def test_hf_safetensors_round_trip(tmp_path):
    """HF-named safetensors, split over two shards with an index, load into
    the same parameters, in float32 and cast to bfloat16 as they land."""
    from safetensors.torch import save_file

    cfg, p = tiny()
    tensors = hf_tensors(cfg, p)
    names = sorted(tensors)
    half = len(names) // 2
    shards = {"a.safetensors": names[:half], "b.safetensors": names[half:]}
    for fname, part in shards.items():
        save_file({n: tensors[n] for n in part}, str(tmp_path / fname))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {n: f for f, part in shards.items() for n in part}}))
    (tmp_path / "config.json").write_text(json.dumps(HF))
    got_cfg, got = ds.load_params(str(tmp_path), cfg, device=CPU, dtype="float32")
    assert got_cfg == cfg

    def flat(tree, pre=""):
        for k, v in tree.items():
            yield from (flat(v, pre + k + ".") if isinstance(v, dict) else [(pre + k, v)])

    want = dict(flat(p))
    have = dict(flat(got))
    assert want.keys() == have.keys()
    for k in want:
        assert torch.equal(want[k], have[k]), k
    _, half_p = ds.load_params(str(tmp_path), cfg, device=CPU, dtype="bfloat16")
    assert half_p["moe"]["gate"].dtype == torch.bfloat16
    assert half_p["moe"]["router"].dtype == torch.float32
    assert half_p["layers"]["kv_norm"].dtype == torch.float32
    assert torch.equal(half_p["moe"]["down"], p["moe"]["down"].to(torch.bfloat16))


def test_logits_match_transformers_deepseek_v2(tmp_path):
    """An independent implementation: transformers' DeepseekV2ForCausalLM
    at plain RoPE (its YaRN path scales attention differently from
    DeepSeek's remote code, which the port follows), saved with
    save_pretrained and loaded through the port's loader and config."""
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV2ForCausalLM"):
        pytest.skip("this transformers has no DeepseekV2")
    hcfg = transformers.DeepseekV2Config(
        vocab_size=300, hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8,
        n_shared_experts=2, num_experts_per_tok=3, first_k_dense_replace=1, kv_lora_rank=32,
        q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=12,
        max_position_embeddings=256, rope_scaling=None, norm_topk_prob=False,
        topk_method="greedy", tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(3)
    m = transformers.DeepseekV2ForCausalLM(hcfg).eval()
    with torch.no_grad():
        for prm in m.parameters():
            prm.normal_(0, 0.1) if prm.dim() > 1 else prm.uniform_(0.5, 1.5)
    m.save_pretrained(str(tmp_path), safe_serialization=True)
    hf = json.loads((tmp_path / "config.json").read_text())
    cfg = ds.DeepseekV2Config.from_model_dir(str(tmp_path), 128, "float32")
    _, p = ds.load_params(str(tmp_path), cfg, device=CPU, dtype="float32")
    ids = ids_of(20, seed=2)
    with torch.no_grad():
        want = m(ids).logits[0]
    got, _ = tm.model_forward(cfg, p, ids, torch.arange(20)[None],
                              tm.init_cache(cfg, device=CPU), 0)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=HF_TOL, rtol=0)
    # The reference straight from transformers' own tensors, not the port's loader.
    np.testing.assert_allclose(
        ref.logits(hf, m.state_dict().__getitem__, ids[0].tolist(), list(range(20))).numpy(),
        want.numpy(), atol=HF_TOL, rtol=0)


def deepseek_llm(tmp_path, max_context=640, **sampler):
    cfg, p = tiny(max_context=max_context)
    return trt.LocalLLM(cfg, p, trt.ByteTokenizer(),
                        tm.SamplerConfig(temperature=0.0, repetition_penalty=1.0, **sampler),
                        model_name="tiny-dsv2", device=CPU)


def test_local_llm_runs_the_family_through_generate_and_stream(tmp_path, monkeypatch):
    """generate (batch) and _stream give the same greedy text; the emitted
    ids are the reference's greedy choices; the spans and counters land."""
    metrics = Metrics()
    monkeypatch.setattr(tm, "METRICS", metrics)
    monkeypatch.setattr(trt, "METRICS", metrics)
    monkeypatch.setattr(ds, "METRICS", metrics)
    llm = deepseek_llm(tmp_path)
    msgs = [ChatMessage(ChatRole.System, "extract"), ChatMessage(ChatRole.User, "a b c " * 30)]
    text = llm.chat_completion("m", msgs, max_new=12)
    ids = llm.last_completion["ids"]
    n = llm.last_completion["prompt_ids"]
    assert len(ids) == 12 and n > 64
    padded, _, _ = llm.encode_prompt(msgs, 12)
    assert padded.shape[1] == 128  # the bucket
    seq = padded[0, :n].tolist() + ids
    want = ref.logits(HF, hf_tensors(llm.cfg, llm.params).__getitem__, seq[:-1],
                      list(range(n - 1, n + 11)))
    assert want.argmax(-1).tolist() == ids
    c = metrics.snapshot()["counters"]
    assert c["llm.prompt_tokens"] == n and c["llm.decode_tokens"] == 12
    assert c["llm.prefill_dev_n"] == c["llm.decode_dev_n"] == c["llm.prefill_n"] == 1
    assert c["llm.moe_dev_n"] == 2 and c["llm.moe_dev_us"] <= c["llm.prefill_dev_us"]
    pieces = []
    assert llm.chat_completion("m", msgs, on_token=pieces.append, max_new=12) == text
    assert "".join(pieces) == text and llm.last_completion["ids"] == ids
    c = metrics.snapshot()["counters"]
    assert c["llm.prefill_dev_n"] == 2 and c["llm.decode_tokens"] >= 24
    assert c["llm.decode_dev_n"] >= 2 and c["llm.moe_dev_n"] == 4


def test_device_spans_count_only_inside_a_timing_scope():
    m = Metrics()
    with m.device_span("x", CPU):
        pass
    assert "x_n" not in m.snapshot()["counters"]
    with m.device_timing() as timing:
        with m.device_span("x", CPU, {"x.items": 5}):
            pass
        with m.device_span("x", CPU, {"x.items": 2}):
            pass
    assert "x_n" not in m.snapshot()["counters"]
    timing.count()
    c = m.snapshot()["counters"]
    assert c["x_n"] == 2 and c["x.items"] == 7 and c["x_us"] >= 0
    timing.count()  # counted once
    assert m.snapshot()["counters"]["x_n"] == 2


def write_toml(tmp_path, body):
    path = tmp_path / "llm.toml"
    path.write_text(body)
    return str(path)


def test_from_config_loads_deepseek_from_config_json_and_a_seed(tmp_path):
    """config.json names the family and its widths; the weights, drawn
    from a seed, come in memory by HF's names (`weights=`)."""
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(HF))
    want_cfg = ds.DeepseekV2Config.from_hf(HF, max_context=1024, compute_dtype="float32")
    want = ds.init_params(want_cfg, seed=5, device=CPU, dtype="float32")
    weights = _InMemory(hf_tensors(want_cfg, want))
    llm = trt.LocalLLM.from_config(write_toml(
        tmp_path, f'[model]\npath = "{d}"\nparam_dtype = "float32"\nmax_context = 1024\n'
                  "[sampler]\ntemperature = 0.0\n"), device=CPU, weights=weights)
    assert llm.cfg == want_cfg and llm.max_tokens == 1024 - 612
    assert torch.equal(llm.params["moe"]["gate"], want["moe"]["gate"])
    assert isinstance(llm.chat_completion("m", [ChatMessage(ChatRole.User, "hi")], max_new=4),
                      str)
    with pytest.raises(ValueError, match="param_dtype"):
        trt.LocalLLM.from_config(write_toml(
            tmp_path, f'[model]\npath = "{d}"\nparam_dtype = "int8"\n'), device=CPU,
            weights=weights)
    bf16 = trt.LocalLLM.from_config(write_toml(tmp_path, f'[model]\npath = "{d}"\n'),
                                    device=CPU, weights=weights)
    assert torch.equal(bf16.params["moe"]["up"], want["moe"]["up"].to(torch.bfloat16))
    assert bf16.params["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("body,match", [
    ('[model]\npath = "tiny"\ntype = "mamba"\n', "unknown local LLM family"),
    ('[model]\npath = "{dir}"\n', "unknown local LLM family"),          # model_type qwen2
    ('[model]\npath = "{dir}/absent"\ntype = "deepseek_v2"\n', "needs a model directory"),
    ('[model]\npath = "tiny"\ntype = "deepseek_v2"\n', "needs a model directory"),
])
def test_from_config_raises_on_what_it_does_not_know(tmp_path, body, match):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "qwen2"}))
    with pytest.raises(ValueError, match=match):
        trt.LocalLLM.from_config(write_toml(tmp_path, body.format(dir=tmp_path)), device=CPU)


def test_from_hf_rejects_what_the_port_does_not_compute():
    for key, value in [("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"),
                       ("scoring_func", "sigmoid")]:
        with pytest.raises(ValueError, match=key):
            ds.DeepseekV2Config.from_hf(dict(HF, **{key: value}))
    with pytest.raises(ValueError, match="rope_scaling"):
        ds.DeepseekV2Config.from_hf(dict(HF, rope_scaling={"type": "linear", "factor": 2}))


def test_prompt_buckets_double_up_to_the_window():
    assert trt.prompt_buckets(32768) == (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
    # Unchanged where the window is 4,096 or less.
    assert trt.prompt_buckets(4096) == trt._PROMPT_BUCKETS
    assert trt.prompt_buckets(640) == (64, 128, 256, 512)
    llm = deepseek_llm(None, max_context=32768)
    for n, bucket in [(3000, 4096), (9000, 16384), (20000, 32256)]:
        padded, got, max_new = llm.encode_prompt([ChatMessage(ChatRole.User, "x" * n)], 96)
        assert padded.shape == (1, bucket) and got == n + 1 + len("[INST]  [/INST]")
        assert max_new == 96


@pytest.mark.parametrize("prefill", [True, False])
def test_moe_tap_sees_the_routing_the_reference_computes(prefill):
    """`moe_tap` hands a checker each MoE layer's input rows, its expert
    ids and its routed and shared sums; on those same rows the reference's
    MoE layer chooses the same experts and sums alike. Both the grouped
    (prefill) and the gathered (decode) paths."""
    cfg, p = tiny()
    w = hf_tensors(cfg, p).__getitem__
    ids = ids_of(12, seed=4)
    seen = []

    def tap(layer, x, weights, idx, routed, shared):
        seen.append((layer, x.clone(), idx.clone(), routed.clone(), shared.clone()))

    cache = tm.init_cache(cfg, device=CPU)
    with ds.moe_tap(tap):
        if prefill:
            tm.model_forward(cfg, p, ids, torch.arange(12)[None], cache, 0)
        else:
            for t in range(3):
                pos = torch.tensor(t)
                tm.model_forward(cfg, p, ids[:, t:t + 1], pos.view(1, 1), cache, pos)
    tm.model_forward(cfg, p, ids, torch.arange(12)[None], tm.init_cache(cfg, device=CPU), 0)
    assert [s[0] for s in seen] == [1, 2] * (1 if prefill else 3)  # none after the scope
    for layer, x, idx, routed, shared in seen:
        assert x.shape[0] == (12 if prefill else 1) and idx.shape[1] == 3
        want_idx, want_routed, want_shared = ref.moe(HF, w, layer, x.float())
        assert torch.equal(idx.sort(-1).values, want_idx.sort(-1).values)
        torch.testing.assert_close(routed, want_routed, atol=TOL, rtol=0)
        torch.testing.assert_close(shared.float(), want_shared, atol=TOL, rtol=0)
        assert float(routed.norm()) > 0.1 * float(shared.norm())  # routing moves the sum


def test_weights_load_from_tensors_in_memory():
    """`load_params(tensors=...)` reads HF-named tensors held in memory,
    each once, into the same parameters as the safetensors path; only
    deepseek_v2 takes them through `from_config`."""
    cfg, p = tiny()
    tensors = hf_tensors(cfg, p)
    src = _InMemory(tensors)
    _, got = ds.load_params("unused", cfg, device=CPU, dtype="float32", tensors=src)
    assert sorted(src.read) == sorted(tensors)
    for group in ("layers", "dense", "moe"):
        for k in p[group]:
            assert torch.equal(got[group][k], p[group][k]), (group, k)
    for k in ("embed", "final_norm", "lm_head"):
        assert torch.equal(got[k], p[k]), k


@pytest.mark.parametrize("path", ["tiny", "tiny-gptj"])
def test_only_deepseek_takes_weights_in_memory(tmp_path, path):
    with pytest.raises(ValueError, match="weights= is for deepseek_v2"):
        trt.LocalLLM.from_config(write_toml(tmp_path, f'[model]\npath = "{path}"\n'),
                                 device=CPU, weights=_InMemory({}))
