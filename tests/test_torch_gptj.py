"""The port's GPT-J decoder (memex_tpu_torch/llm/local/gptj.py) against
memex_tpu's on the same weights (carried across with `params_from_jax`),
and against an HF GPTJForCausalLM built from a local config. Tolerances
are test_torch_llm.py's, for the same reasons: LOGIT_TOL for float32
compute (summation order), BF16_TOL for bf16 compute (a bf16 ulp of a
projection rounding either way); tokens, codes and leaves exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.llm.local import gptj as jg
from memex_tpu.llm.local import model as jm
from memex_tpu.llm.local import runtime as jrt
from memex_tpu_torch.llm.local import gptj as tg
from memex_tpu_torch.llm.local import model as tm
from memex_tpu_torch.llm.local import runtime as trt
from test_torch_llm import (
    BF16_TOL,
    CPU,
    LOGIT_TOL,
    assert_bit_equal,
    chat_pair,
    greedy_tokens,
    numpy_tree,
    port_llm,
    run_forward,
    torch_cfg,
)

torch.set_num_threads(2)

CFG = jg.GptJConfig.tiny()   # rotary_dim 16 < head_dim 32


@pytest.fixture(scope="module")
def jax_params():
    return jg.init_params(CFG, seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_params_carry_across_bit_equal(jax_params, dtype):
    """Biases, both LayerNorms and lm_head_bias stay float32; fc_in,
    fc_out and lm_head convert with the Llama keys; int8 codes and scales
    equal memex_tpu's."""
    pt = tm.params_from_jax(numpy_tree(jax_params), CPU)
    assert_bit_equal(jax_params, pt)
    jc = jm.convert_params(jax_params, dtype)
    assert_bit_equal(jc, tm.params_from_jax(numpy_tree(jc), CPU))
    assert_bit_equal(jc, tm.convert_params(pt, dtype))


@pytest.mark.parametrize("dtype,compute,tol", [("float32", "float32", LOGIT_TOL),
                                               ("int8", "float32", LOGIT_TOL),
                                               ("bfloat16", "bfloat16", BF16_TOL)])
def test_forward_logits_match_memex_tpu(jax_params, dtype, compute, tol):
    """Prefill (T = 12) and a cached decode step (cache_len = 12)."""
    pt = tm.params_from_jax(numpy_tree(jax_params), CPU)
    for want, got in run_forward(CFG, jax_params, pt, dtype, compute):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_rotary_and_layer_norm_match():
    """Interleaved rotary on the first rotary_dim dims, the rest untouched."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(1, 5))
    got = tg._rotary_every_two(torch.from_numpy(x), torch.from_numpy(pos), 16).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jg._rotary_every_two(jnp.asarray(x), jnp.asarray(pos), 16)), atol=2e-5)
    assert np.array_equal(got[..., 16:], x[..., 16:])
    h = (rng.standard_normal((1, 5, 128)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(128).astype(np.float32), rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        tg._layer_norm(*map(torch.from_numpy, (h, s, b)), 1e-5).numpy(),
        np.asarray(jg._layer_norm(jnp.asarray(h), jnp.asarray(s), jnp.asarray(b), 1e-5)),
        atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_greedy_generate_gives_memex_tpus_tokens(jax_params, dtype):
    (want, n_want), (got, n_got) = greedy_tokens(CFG, jax_params, dtype, eos_id=-7)
    assert got == want and n_got == n_want == len(want)
    eos = want[10]
    (want, n_want), (got, n_got) = greedy_tokens(CFG, jax_params, dtype, eos_id=eos)
    assert got == want and n_got == n_want
    first = want.index(eos)   # the eos step counts; the steps after it do not
    assert first <= 10 and n_want == first + 1 and set(want[first:]) == {eos}


def test_chat_completion_batch_and_stream_give_memex_tpus_text():
    cfg = dataclasses.replace(jg.GptJConfig.tiny(vocab_size=258), max_context=640)
    jax_llm = jrt.LocalLLM(cfg, jg.init_params(cfg, seed=2), jrt.ByteTokenizer(),
                           jm.SamplerConfig(temperature=0.0), model_name="tiny-gptj")
    llm = port_llm(jax_llm)
    assert llm.cfg.model_family == "gptj"
    jmsg, tmsg = chat_pair("hello gpt-j")
    want = jax_llm.chat_completion("m", jmsg, max_new=32)
    assert llm.chat_completion("m", tmsg, max_new=32) == want
    pieces = []
    assert llm.chat_completion("m", tmsg, on_token=pieces.append, max_new=32) == want
    assert "".join(pieces) == want


def test_hf_checkpoint_logits_match_hf_and_memex_tpu(tmp_path):
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.GPTJConfig(vocab_size=256, n_positions=128, n_embd=64, n_layer=3,
                                   n_head=4, rotary_dim=8, n_inner=176,
                                   activation_function="gelu_new", layer_norm_epsilon=1e-5,
                                   tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.GPTJForCausalLM(hcfg).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, params = tg.load_params(str(tmp_path), device=CPU)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    assert (cfg.rotary_dim, cfg.num_layers, cfg.intermediate_size) == (8, 3, 176)
    ids = np.random.default_rng(0).integers(3, 250, size=(1, 12))
    with torch.no_grad():
        golden = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
    got, _ = tg.forward(cfg, params, torch.from_numpy(ids), torch.arange(12)[None],
                        tm.init_cache(cfg, device=CPU), 0)
    assert np.array_equal(got.numpy().argmax(-1), golden.argmax(-1))
    np.testing.assert_allclose(got.numpy(), golden, atol=2e-3, rtol=2e-3)
    jcfg, jp = jg.load_params(str(tmp_path))
    assert torch_cfg(jcfg) == dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert_bit_equal(jp, params)
    want, _ = jg.forward(dataclasses.replace(jcfg, compute_dtype="float32"), jp,
                         jnp.asarray(ids, jnp.int32), jnp.arange(12)[None],
                         jm.init_cache(jcfg), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_from_config_tiny_gptj(tmp_path):
    for body in ('[model]\npath = "tiny-gptj"\n', '[model]\npath = "tiny"\ntype = "gptj"\n'):
        path = tmp_path / "gptj.toml"
        path.write_text(body)
        llm = trt.LocalLLM.from_config(str(path), device=CPU)
        assert llm.cfg == tg.GptJConfig.tiny(vocab_size=258) and llm.device == CPU
        assert "lm_head_bias" in llm.params
    pieces = []
    out = llm.chat_completion("m", chat_pair("hi")[1], on_token=pieces.append, max_new=12)
    assert isinstance(out, str) and "".join(pieces) == out


def test_hf_dir_family_is_sniffed_from_config_json(tmp_path):
    """type defaults to llama; a GPT-J checkpoint's config.json says gptj."""
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.GPTJConfig(vocab_size=258, n_positions=640, n_embd=32, n_layer=1,
                                   n_head=4, rotary_dim=4, n_inner=64)
    transformers.GPTJForCausalLM(hcfg).save_pretrained(str(tmp_path / "m"),
                                                        safe_serialization=True)
    toml = tmp_path / "llm.toml"
    toml.write_text(f'[model]\npath = "{tmp_path}/m"\nparam_dtype = "int8"\n'
                    "[sampler]\ntemperature = 0.0\n")
    llm = trt.LocalLLM.from_config(str(toml), device=CPU)
    jax_llm = jrt.LocalLLM.from_config(str(toml))
    assert llm.cfg.model_family == "gptj" and llm.params["lm_head"]["q"].dtype == torch.int8
    assert_bit_equal(jax_llm.params, llm.params)
    jmsg, tmsg = chat_pair("sniff")
    assert llm.chat_completion("m", tmsg, max_new=8) == jax_llm.chat_completion(
        "m", jmsg, max_new=8)
