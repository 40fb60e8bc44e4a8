"""The port's local Llama decoder (memex_tpu_torch/llm/local/) against
memex_tpu's on the same weights: memex_tpu's parameter tree carried across
with `params_from_jax`, inputs from a numpy seed, both on the CPU.

Tolerances:
- LOGIT_TOL (float32 and int8 weights, float32 compute): both packages
  sum the same float32 products in different orders (XLA's dot against
  torch's), a few float32 ulps of logits below 1 through two layers;
  3.6e-7 measured, 1e-5 leaves a margin of ~30x and is far below the
  0.02 weight scale any real fault would move.
- BF16_TOL (bfloat16 compute): each projection rounds its output to bf16
  in both packages, and a bf16 ulp (2^-8 relative) in either can round
  the other way, so logits differ by a few bf16 ulps of the activations.
- Tokens under greedy decoding and `sample_token` under fed Gumbel noise
  are compared exactly, as are int8 codes and scales and carried leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.llm.local import model as jm
from memex_tpu.llm.local import runtime as jrt
from memex_tpu.llm.base import ChatMessage as JaxMessage, ChatRole as JaxRole
from memex_tpu_torch.llm.base import ChatMessage, ChatRole
from memex_tpu_torch.llm.local import gptj as tg
from memex_tpu_torch.llm.local import model as tm
from memex_tpu_torch.llm.local import runtime as trt

torch.set_num_threads(2)

LOGIT_TOL = 1e-5
BF16_TOL = 2e-2
CPU = torch.device("cpu")


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def assert_bit_equal(jax_tree, torch_tree):
    a, b = flat(numpy_tree(jax_tree)), flat(torch_tree)
    assert a.keys() == b.keys()
    for k in a:
        want = a[k]
        got = b[k]
        if want.dtype.name == "bfloat16":
            want, got = want.view(np.int16), got.view(torch.int16)
        assert str(got.dtype).endswith(str(want.dtype)), (k, got.dtype, want.dtype)
        assert np.array_equal(want, got.numpy()), k


CONFIGS = {
    "llama-gqa": jm.LlamaConfig.tiny(),                                   # 4 heads over 2
    "llama-mha": dataclasses.replace(jm.LlamaConfig.tiny(), num_kv_heads=4),
}


def torch_cfg(cfg):
    """The port's config equal to memex_tpu's `cfg`, of either family."""
    cls = tg.GptJConfig if getattr(cfg, "model_family", "llama") == "gptj" else tm.LlamaConfig
    return cls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_params():
    return {name: jm.init_params(cfg, seed=0) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_params_carry_across_bit_equal(jax_params, dtype):
    """params_from_jax keeps every leaf; converting the carried float32
    tree here gives memex_tpu's converted tree bit for bit (int8 codes and
    scales included)."""
    jp = jax_params["llama-gqa"]
    pt = tm.params_from_jax(numpy_tree(jp), CPU)
    assert_bit_equal(jp, pt)
    jc = jm.convert_params(jp, dtype)
    assert_bit_equal(jc, tm.params_from_jax(numpy_tree(jc), CPU))
    assert_bit_equal(jc, tm.convert_params(pt, dtype))


def test_convert_params_rejects_an_unknown_dtype(jax_params):
    pt = tm.params_from_jax(numpy_tree(jax_params["llama-gqa"]), CPU)
    with pytest.raises(ValueError, match="fp4"):
        tm.convert_params(pt, "fp4")
    assert tm.convert_params(pt, "f32") is pt


def run_forward(cfg, jp, pt, dtype, compute="float32", T=12):
    """Prefill of T tokens, then one decode step at cache_len = T, in both
    packages; returns the (jax, torch) logits of each."""
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    tcfg = torch_cfg(cfg)
    jc, tc = jm.convert_params(jp, dtype), tm.convert_params(pt, dtype)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=(1, T + 1)).astype(np.int32)
    fwd_j = jm.model_forward
    lj, cj = fwd_j(cfg, jc, jnp.asarray(ids[:, :T]), jnp.arange(T)[None], jm.init_cache(cfg), 0)
    sj, _ = fwd_j(cfg, jc, jnp.asarray(ids[:, T:]), jnp.asarray([[T]]), cj, T)
    cache = tm.init_cache(tcfg, device=CPU)
    lt, cache = tm.model_forward(tcfg, tc, torch.from_numpy(ids[:, :T]).long(),
                                 torch.arange(T)[None], cache, 0)
    st, _ = tm.model_forward(tcfg, tc, torch.from_numpy(ids[:, T:]).long(),
                             torch.tensor([[T]]), cache, torch.tensor(T))
    return (np.asarray(lj), lt.numpy()), (np.asarray(sj), st.numpy())


@pytest.mark.parametrize("dtype,compute,tol", [("float32", "float32", LOGIT_TOL),
                                               ("int8", "float32", LOGIT_TOL),
                                               ("bfloat16", "bfloat16", BF16_TOL)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_memex_tpu(jax_params, name, dtype, compute, tol):
    """Prefill (T = 12) and a cached decode step (cache_len = 12), GQA and
    MHA, float32 / int8 weights with float32 compute and bf16 throughout."""
    cfg = CONFIGS[name]
    jp = jax_params[name]
    pt = tm.params_from_jax(numpy_tree(jp), CPU)
    for want, got in run_forward(cfg, jp, pt, dtype, compute):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_rope_and_rms_norm_match(jax_params):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(1, 7))
    np.testing.assert_allclose(
        tm._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jm._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), atol=2e-5)
    h = rng.standard_normal((1, 7, 128)).astype(np.float32)
    s = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        tm._rms_norm(torch.from_numpy(h), torch.from_numpy(s), 1e-5).numpy(),
        np.asarray(jm._rms_norm(jnp.asarray(h), jnp.asarray(s), 1e-5)), atol=1e-6)


def test_cached_decode_matches_full_forward(jax_params):
    """KV-cached step-by-step decode == one full forward (cache math)."""
    cfg = torch_cfg(CONFIGS["llama-gqa"])
    pt = tm.params_from_jax(numpy_tree(jax_params["llama-gqa"]), CPU)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(1, 10))).long()
    full, _ = tm.forward(cfg, pt, ids, torch.arange(10)[None], tm.init_cache(cfg, device=CPU), 0)
    cache = tm.init_cache(cfg, device=CPU)
    steps = []
    for t in range(10):
        lg, cache = tm.forward(cfg, pt, ids[:, t:t + 1], torch.tensor([[t]]), cache,
                               torch.tensor(t))
        steps.append(lg[0, 0])
    np.testing.assert_allclose(full[0].numpy(), torch.stack(steps).numpy(), atol=1e-4)


# -- sampling ------------------------------------------------------------------

SAMPLERS = {
    "greedy": jm.SamplerConfig(temperature=0.0),
    "topk-topp": jm.SamplerConfig(),                       # top_k 40 then top_p 0.95
    "topk-only": jm.SamplerConfig(top_p=1.0, top_k=8),
    "full-vocab-topp": jm.SamplerConfig(top_k=0, top_p=0.9),
    "full-vocab": jm.SamplerConfig(top_k=0, top_p=1.0, temperature=1.3),
}


def test_categorical_is_argmax_plus_gumbel():
    """The identity the port's sampler rests on, in this jax."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal(300).astype(np.float32))
    for i in range(20):
        key = jax.random.PRNGKey(i)
        assert int(jax.random.categorical(key, x)) == int(
            jnp.argmax(x + jax.random.gumbel(key, x.shape)))


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sample_token_matches_memex_tpu_under_the_same_noise(name):
    """sample_token picks memex_tpu's token when fed memex_tpu's Gumbel
    noise, with repeated and padded entries in the penalty window."""
    sc = SAMPLERS[name]
    tsc = tm.SamplerConfig(**dataclasses.asdict(sc))
    rng = np.random.default_rng(4)
    V = 512
    for i in range(40):
        logits = (rng.standard_normal(V) * 3).astype(np.float32)
        recent = rng.integers(-1, 64, size=64).astype(np.int32)   # repeats and -1 pads
        key = jax.random.PRNGKey(i)
        want = int(jm.sample_token(jnp.asarray(logits), jnp.asarray(recent), key, sc))

        def noise(shape, key=key):
            return torch.from_numpy(np.array(jax.random.gumbel(key, tuple(shape))))

        got = tm.sample_token(torch.from_numpy(logits), torch.from_numpy(recent).long(),
                              tsc, noise)
        assert got.dim() == 0 and int(got) == want, (i, int(got), want)


def test_topk_ties_break_to_the_lower_index():
    """lax.top_k keeps the lower index among equal values at the k-th
    place; so does the port's stable sort."""
    logits = np.zeros(64, np.float32)
    logits[[5, 9, 30, 41]] = 2.0                     # four tied, k = 2
    sc = jm.SamplerConfig(top_k=2, top_p=1.0, repetition_penalty=1.0)
    key = jax.random.PRNGKey(0)
    for i in range(16):
        key, sub = jax.random.split(key)
        want = int(jm.sample_token(jnp.asarray(logits), jnp.full(4, -1, jnp.int32), sub, sc))
        got = tm.sample_token(torch.from_numpy(logits), torch.full((4,), -1),
                              tm.SamplerConfig(**dataclasses.asdict(sc)),
                              lambda s, sub=sub: torch.from_numpy(
                                  np.array(jax.random.gumbel(sub, tuple(s)))))
        assert int(got) == want and want in (5, 9)


# -- generation ----------------------------------------------------------------

GREEDY = jm.SamplerConfig(temperature=0.0)


def greedy_tokens(cfg, jp, dtype, eos_id, max_new=24, prompt_len=9):
    prompt = np.zeros((1, 64), np.int32)
    prompt[0, :prompt_len] = np.random.default_rng(5).integers(0, 256, size=prompt_len)
    jc = jm.convert_params(jp, dtype)
    tj, nj = jm.generate(cfg, jc, jnp.asarray(prompt), jnp.int32(prompt_len),
                         jax.random.PRNGKey(0), GREEDY, max_new, eos_id=eos_id)
    tcfg = torch_cfg(cfg)
    tc = tm.convert_params(tm.params_from_jax(numpy_tree(jp), CPU), dtype)
    tt, nt = tm.generate(tcfg, tc, torch.from_numpy(prompt).long(), prompt_len,
                         tm.SamplerConfig(**dataclasses.asdict(GREEDY)), max_new,
                         torch.Generator().manual_seed(0), eos_id=eos_id)
    return (np.asarray(tj).tolist(), int(nj)), (tt.tolist(), int(nt))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_gives_memex_tpus_tokens(jax_params, name, dtype):
    """Identical greedy tokens; then with eos set to a token the run emits
    mid-way, the same eos fill after it and the same n_valid."""
    cfg, jp = CONFIGS[name], jax_params[name]
    (want, n_want), (got, n_got) = greedy_tokens(cfg, jp, dtype, eos_id=-7)
    assert got == want and n_got == n_want == len(want)
    eos = want[10]
    (want, n_want), (got, n_got) = greedy_tokens(cfg, jp, dtype, eos_id=eos)
    assert got == want and n_got == n_want
    first = want.index(eos)   # the eos step counts; the steps after it do not
    assert first <= 10 and n_want == first + 1 and set(want[first:]) == {eos}


def port_llm(jax_llm, sampler=None, device=CPU):
    tcfg = torch_cfg(jax_llm.cfg)
    sc = tm.SamplerConfig(**dataclasses.asdict(sampler or jax_llm.sampler))
    return trt.LocalLLM(tcfg, tm.params_from_jax(numpy_tree(jax_llm.params), device),
                        trt.ByteTokenizer(), sc, model_name=jax_llm.default_model,
                        device=device)


def chat_pair(text):
    return ([JaxMessage(JaxRole.System, "be brief"), JaxMessage(JaxRole.User, text)],
            [ChatMessage(ChatRole.System, "be brief"), ChatMessage(ChatRole.User, text)])


@pytest.mark.parametrize("max_context", [256, 640])
def test_chat_completion_batch_and_stream_give_memex_tpus_text(max_context):
    """LocalLLM.chat_completion, batch and streaming, greedy: memex_tpu's
    text. At the tiny model's 256-token context memex_tpu drops the whole
    prompt (max_prompt = 256 - 512 < 0); the port does the same. At 640
    the prompt is kept (max_prompt 128)."""
    cfg = dataclasses.replace(jm.LlamaConfig.tiny(vocab_size=258), max_context=max_context)
    jax_llm = jrt.LocalLLM(cfg, jm.init_params(cfg, seed=6), jrt.ByteTokenizer(),
                           jm.SamplerConfig(temperature=0.0))
    llm = port_llm(jax_llm)
    jmsg, tmsg = chat_pair("summarize: the quick brown fox")
    want = jax_llm.chat_completion("m", jmsg, max_new=40)
    assert llm.chat_completion("m", tmsg, max_new=40) == want
    pieces, jpieces = [], []
    assert llm.chat_completion("m", tmsg, on_token=pieces.append, max_new=40) == want
    jax_llm.chat_completion("m", jmsg, on_token=jpieces.append, max_new=40)
    assert "".join(pieces) == want and pieces == jpieces


def test_stream_matches_batch_under_sampling():
    """With the default sampler, two models seeded alike give the same text
    batch and streaming: the streaming lookahead draws in step order."""
    a = trt.LocalLLM.tiny(seed=3, device=CPU)
    b = trt.LocalLLM.tiny(seed=3, device=CPU)
    m = [ChatMessage(ChatRole.User, "xyz")]
    batch = a.chat_completion("tiny", m, max_new=24)
    pieces = []
    assert b.chat_completion("tiny", m, on_token=pieces.append, max_new=24) == batch
    assert "".join(pieces) == batch


def test_decode_chunk_reads_nothing_back(monkeypatch):
    """Inside a chunk no value leaves the device (so a step stays
    capturable later): every device -> host read is trapped while
    decode_chunk runs, and the chunk still finishes."""
    llm = trt.LocalLLM.tiny(seed=1, device=CPU)
    padded, n, _ = llm.encode_prompt([ChatMessage(ChatRole.User, "hi")], 8)
    carry = tm.prefill(llm.cfg, llm.params, padded, n, llm.sampler)

    def trap(name):
        return lambda *a, **k: pytest.fail(f"host read inside decode_chunk: {name}")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "nonzero", "cpu", "numpy", "__int__", "__bool__",
                     "__float__", "__index__"):
            m.setattr(torch.Tensor, name, trap(name))
        carry, toks, was_done = tm.decode_chunk(llm.cfg, llm.params, carry, llm.sampler, 6,
                                                llm._gen, eos_id=257)
    assert toks.shape == (6,) and was_done.shape == (6,) and int(carry[3]) == n + 6


def test_stream_reads_once_a_chunk(monkeypatch):
    """The stream enqueues chunk i+1 before it reads chunk i, and reads
    each chunk's tokens once."""
    llm = trt.LocalLLM.tiny(seed=4, device=CPU)
    llm.STREAM_CHUNK = 4
    events = []
    real = trt.decode_chunk

    def counting(*a, **k):
        events.append("enqueue")
        return real(*a, **k)

    real_tolist = torch.Tensor.tolist

    def reading(self):
        events.append("read")
        return real_tolist(self)

    monkeypatch.setattr(trt, "decode_chunk", counting)
    monkeypatch.setattr(torch.Tensor, "tolist", reading)
    llm.chat_completion("tiny", [ChatMessage(ChatRole.User, "count")],
                        on_token=lambda s: None, max_new=16)
    # FIRST_CHUNK 4 then chunks of 4 up to 16 tokens: 4 enqueues, each
    # read after the next one is enqueued.
    assert events[:5] == ["enqueue", "enqueue", "read", "enqueue", "read"]
    assert events.count("read") == events.count("enqueue") == 4


# -- checkpoints and configs ---------------------------------------------------


def test_hf_checkpoint_logits_match_hf_and_memex_tpu(tmp_path):
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176, num_hidden_layers=3,
        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hcfg).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg, params = tm.load_params(str(tmp_path), device=CPU)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    assert (cfg.num_kv_heads, cfg.num_layers, cfg.max_context) == (4, 3, 128)
    ids = np.random.default_rng(0).integers(3, 250, size=(1, 12))
    with torch.no_grad():
        golden = hf(input_ids=torch.from_numpy(ids)).logits.numpy()
    got, _ = tm.forward(cfg, params, torch.from_numpy(ids), torch.arange(12)[None],
                        tm.init_cache(cfg, device=CPU), 0)
    assert np.array_equal(got.numpy().argmax(-1), golden.argmax(-1))
    np.testing.assert_allclose(got.numpy(), golden, atol=2e-3, rtol=2e-3)
    jcfg, jp = jm.load_params(str(tmp_path))
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    want, _ = jm.forward(jcfg, jp, jnp.asarray(ids, jnp.int32), jnp.arange(12)[None],
                         jm.init_cache(jcfg), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


def test_bf16_checkpoint_loads_as_in_memex_tpu(tmp_path):
    """A bfloat16 checkpoint loads to memex_tpu's float32 weights bit for
    bit. (memex_tpu reads it through numpy, which knows bfloat16 because
    jax loads ml_dtypes; the port reads torch tensors.)"""
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    max_position_embeddings=64)
    transformers.LlamaForCausalLM(hcfg).to(torch.bfloat16).save_pretrained(
        str(tmp_path), safe_serialization=True)
    jcfg, jp = jm.load_params(str(tmp_path))
    cfg, params = tm.load_params(str(tmp_path), device=CPU)
    assert cfg == torch_cfg(jcfg)
    assert_bit_equal(jp, params)


def write_toml(tmp_path, body):
    path = tmp_path / "llm.toml"
    path.write_text(body)
    return str(path)


def test_from_config_tiny_and_missing_dir(tmp_path):
    llm = trt.LocalLLM.from_config(
        write_toml(tmp_path, '[model]\npath = "tiny"\nname = "t"\n[sampler]\ntemperature = 0.0\n'),
        device=CPU)
    assert llm.default_model == "t" and llm.cfg == tm.LlamaConfig.tiny(vocab_size=258)
    assert llm.sampler.temperature == 0.0 and llm.device == CPU
    assert llm.params["layers"]["q"].device == CPU
    m = [ChatMessage(ChatRole.User, "x")]
    assert llm.chat_completion("m", m, max_new=4) == llm.chat_completion("m", m, max_new=4)
    gone = trt.LocalLLM.from_config(
        write_toml(tmp_path, f'[model]\npath = "{tmp_path}/nothing"\n'), device=CPU)
    assert gone.cfg == tm.LlamaConfig.tiny(vocab_size=258)


def test_a_family_registered_in_the_table_is_reached_with_no_other_edit(tmp_path, monkeypatch):
    """One FAMILIES entry is all a new family needs: the tiny Llama under
    another name is picked by the TOML `type`, built from its own tiny
    config, and driven by model_forward and init_cache through its own
    record, with the tiny Llama's text."""
    from memex_tpu_torch.llm.local import families

    calls = {"forward": 0, "init_cache": 0}

    def forward(*a, **kw):
        calls["forward"] += 1
        return tm.forward(*a, **kw)

    def init_cache(*a, **kw):
        calls["init_cache"] += 1
        return tm.LLAMA.init_cache(*a, **kw)

    def tiny(vocab_size):
        return dataclasses.replace(tm.LlamaConfig.tiny(vocab_size), model_family="llama-again")

    monkeypatch.setitem(families.FAMILIES, "llama-again", dataclasses.replace(
        tm.LLAMA, name="llama-again", forward=forward, init_cache=init_cache, tiny=tiny))
    toml = write_toml(tmp_path, '[model]\npath = "tiny"\ntype = "llama-again"\n'
                                '[sampler]\ntemperature = 0.0\n')
    llm = trt.LocalLLM.from_config(toml, device=CPU)
    assert llm.cfg.model_family == "llama-again"
    m = [ChatMessage(ChatRole.User, "x")]
    text = llm.chat_completion("m", m, max_new=4)
    assert calls["forward"] == 5 and calls["init_cache"] == 1  # prefill + 4 steps
    ref = trt.LocalLLM.tiny(trt.SamplerConfig(temperature=0.0), device=CPU)
    assert text == ref.chat_completion("m", m, max_new=4)


def hf_llama_dir(path, transformers):
    """A seeded 2-layer HF llama checkpoint over a 258-token vocab."""
    hcfg = transformers.LlamaConfig(vocab_size=258, hidden_size=64, intermediate_size=128,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, max_position_embeddings=640,
                                    tie_word_embeddings=False)
    torch.manual_seed(1)
    transformers.LlamaForCausalLM(hcfg).save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_from_config_param_dtype(tmp_path, dtype):
    """An HF dir loads, converts to param_dtype (as memex_tpu's
    from_config), and serves a greedy chat identical to memex_tpu's."""
    transformers = pytest.importorskip("transformers")
    model_dir = hf_llama_dir(tmp_path / "m", transformers)
    toml = write_toml(tmp_path, f'[model]\npath = "{model_dir}"\nparam_dtype = "{dtype}"\n'
                                "[sampler]\ntemperature = 0.0\n")
    llm = trt.LocalLLM.from_config(toml, device=CPU)
    jax_llm = jrt.LocalLLM.from_config(toml)
    assert isinstance(llm.tokenizer, trt.ByteTokenizer)
    q = llm.params["layers"]["q"]
    if dtype == "int8":
        assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    else:
        assert q.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert_bit_equal(jax_llm.params, llm.params)
    jmsg, tmsg = chat_pair("hello there")
    assert llm.chat_completion("m", tmsg, max_new=12) == jax_llm.chat_completion(
        "m", jmsg, max_new=12)


def test_hf_tokenizer_in_the_model_dir_is_used(tmp_path):
    """A tokenizer.json beside the weights selects HFTokenizer (ids, bos
    and eos from it) in both packages: the same greedy text."""
    transformers = pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    words = ["hello", "there", "summarize", "quick", "brown", "fox", "INST", "SYS",
             "[", "]", "<", ">", "/"] + [f"w{i}" for i in range(200)]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    model_dir = hf_llama_dir(tmp_path / "m", transformers)
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
    ).save_pretrained(model_dir)
    toml = write_toml(tmp_path, f'[model]\npath = "{model_dir}"\n'
                                "[sampler]\ntemperature = 0.0\n")
    llm = trt.LocalLLM.from_config(toml, device=CPU)
    jax_llm = jrt.LocalLLM.from_config(toml)
    assert isinstance(llm.tokenizer, trt.HFTokenizer)
    assert (llm.tokenizer.bos_id, llm.tokenizer.eos_id) == (1, 2)
    jmsg, tmsg = chat_pair("hello there quick brown fox")
    want = jax_llm.chat_completion("m", jmsg, max_new=16)
    assert llm.chat_completion("m", tmsg, max_new=16) == want
    pieces = []
    assert llm.chat_completion("m", tmsg, on_token=pieces.append, max_new=16) == want
    assert "".join(pieces) == want
