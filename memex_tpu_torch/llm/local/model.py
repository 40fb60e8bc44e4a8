"""Llama-family decoder in PyTorch (port of memex_tpu/llm/local/model.py).

Parameters are a dict of tensors in memex_tpu's layer-stacked layout:
every per-layer weight is one [L, ...] tensor and matmul weights are
[in, out], so the forward walks views of the stacks layer by layer.

  - prefill: one forward over the [1, P] padded prompt fills the
    [L, B, max_context, n_kv, hd] bf16 KV cache;
  - decode: one [1, 1] forward a token against the whole cache at static
    shapes, masked by position; the cache is written in place at
    `cache_len` (memex_tpu donates it);
  - GQA attention, RoPE, RMSNorm, SwiGLU; projections in the compute
    dtype, norms, softmax and the residual stream in float32, and the two
    attention products in float32 (memex_tpu's einsums take
    `preferred_element_type=float32`; a bf16 torch matmul would round its
    output to bf16, so the bf16 operands are upcast, which is exact).

`generate`/`decode_chunk` read nothing back to the host inside their loop:
tokens, the done flags, the position and the sampler's window stay on the
device, so the host reads once per chunk (streaming) or once per
generation.

Weights load from HF-format safetensors (llama naming), come from
memex_tpu's parameter tree (`params_from_jax`), or are drawn from a seed
on the device (`init_params`).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ...metrics import METRICS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_context: int = 2048      # reference local context 2048 (schema.rs:26-34)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    model_family: str = "llama"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LlamaConfig":
        """Hermetic test/config-free model."""
        return cls(
            vocab_size=vocab_size, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_context=256,
            compute_dtype="float32",
        )

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "LlamaConfig":
        with open(os.path.join(model_dir, "config.json"), "r", encoding="utf-8") as fh:
            cfg = json.load(fh)
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            intermediate_size=cfg["intermediate_size"],
            max_context=min(cfg.get("max_position_embeddings", 2048), 4096),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
        )


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """0.02 * N(0, 1) in float32, drawn on the device in one call."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(0.02)


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random float32 weights from `seed`, drawn on `device` by a
    torch.Generator there (jax.random and torch draw differently: the
    parity tests carry memex_tpu's weights over with `params_from_jax`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    KV = cfg.num_kv_heads * cfg.head_dim

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "embed": _normal(gen, (cfg.vocab_size, H), device),
        "final_norm": ones((H,)),
        "lm_head": _normal(gen, (H, cfg.vocab_size), device),
        "layers": {
            "attn_norm": ones((L, H)),
            "q": _normal(gen, (L, H, H), device),
            "k": _normal(gen, (L, H, KV), device),
            "v": _normal(gen, (L, H, KV), device),
            "o": _normal(gen, (L, H, H), device),
            "ffn_norm": ones((L, H)),
            "gate": _normal(gen, (L, H, I), device),
            "up": _normal(gen, (L, H, I), device),
            "down": _normal(gen, (L, I, H), device),
        },
    }


def read_safetensors(model_dir: str) -> dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint (one file or an index of shards),
    on the host. Read as torch tensors, so bfloat16 checkpoints load
    (memex_tpu reads them as numpy, which knows bfloat16 only once
    ml_dtypes is loaded, as jax loads it)."""
    from safetensors import safe_open

    tensors: dict[str, torch.Tensor] = {}
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    files = ["model.safetensors"]
    if os.path.exists(index_path):
        with open(index_path) as fh:
            files = sorted(set(json.load(fh)["weight_map"].values()))
    for fname in files:
        with safe_open(os.path.join(model_dir, fname), framework="pt") as f:
            for name in f.keys():
                tensors[name] = f.get_tensor(name)
    return tensors


def stack_layers(tensors: dict[str, torch.Tensor], names: dict, prefix: str, n_layers: int,
                 device) -> dict:
    """{ours: [L, ...] float32 tensor} from per-layer HF tensors
    `{prefix}{i}.{hf}`, transposed ([out, in] -> [in, out]) where asked."""
    out = {}
    for ours, (hf, transpose) in names.items():
        per = [tensors[f"{prefix}{i}.{hf}"] for i in range(n_layers)]
        stacked = torch.stack([a.T if transpose else a for a in per])
        out[ours] = stacked.to(device=device, dtype=torch.float32)
    return out


def hf_tensor(tensors: dict[str, torch.Tensor], name: str, device,
              transpose: bool = False) -> torch.Tensor:
    t = tensors[name]
    t = t.T if transpose else t
    return t.to(device=device, dtype=torch.float32).contiguous()


_HF = {
    "attn_norm": ("input_layernorm.weight", False),
    "q": ("self_attn.q_proj.weight", True),
    "k": ("self_attn.k_proj.weight", True),
    "v": ("self_attn.v_proj.weight", True),
    "o": ("self_attn.o_proj.weight", True),
    "ffn_norm": ("post_attention_layernorm.weight", False),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
}


def load_params(model_dir: str, cfg: LlamaConfig | None = None,
                device="cuda") -> tuple[LlamaConfig, dict]:
    """Load HF llama safetensors ([out,in] weights -> transposed), float32
    on `device`."""
    if cfg is None:
        cfg = LlamaConfig.from_model_dir(model_dir)
    tensors = read_safetensors(model_dir)
    embed = hf_tensor(tensors, "model.embed_tokens.weight", device)
    params = {
        "embed": embed,
        "final_norm": hf_tensor(tensors, "model.norm.weight", device),
        "lm_head": (hf_tensor(tensors, "lm_head.weight", device, transpose=True)
                    if "lm_head.weight" in tensors else embed.T.contiguous()),
        "layers": stack_layers(tensors, _HF, "model.layers.", cfg.num_layers, device),
    }
    return cfg, params


def _tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """One numpy leaf of memex_tpu's tree, bit for bit: bfloat16 arrays
    (ml_dtypes) travel as their int16 bit patterns."""
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: dict, device="cuda") -> dict:
    """memex_tpu's parameter tree (either family; float32, bfloat16 or
    int8 {"q", "s"} leaves), given as numpy arrays, as this package's:
    the same keys and the same layer-stacked [L, in, out] layout, every
    leaf bit-equal."""
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _tensor_from_numpy(v, device))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# weight storage dtypes. Single-token decode reads every weight once a
# token: bf16 storage halves the bytes of float32, int8 halves them again
# with per-out-channel symmetric scales applied after each product.
# ---------------------------------------------------------------------------

# Keys that are matmul weights (either family); everything else (norms,
# biases) stays float32.
_MATMUL_KEYS = frozenset(
    {"q", "k", "v", "o", "gate", "up", "down",       # llama layers
     "fc_in", "fc_out",                               # gptj layers
     "lm_head"}
)


def _quant_cols(w: torch.Tensor) -> dict:
    """[..., in, out] weight -> int8 codes + per-out-channel f32 scales.
    A stacked [L, in, out] weight is coded one layer at a time, which
    bounds the float temporaries to one layer's."""
    if w.dim() == 3:
        parts = [_quant_cols(w[i]) for i in range(w.shape[0])]
        return {"q": torch.stack([p["q"] for p in parts]),
                "s": torch.stack([p["s"] for p in parts])}
    a = w.abs().amax(dim=-2)
    s = torch.clamp(a, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def convert_params(params: dict, dtype: str = "bfloat16") -> dict:
    """Convert matmul weights to a serving storage dtype.

    dtype: "float32" (no-op), "bfloat16" (default for serving), or "int8"
    (per-out-channel symmetric; embed per-row). The forward pass accepts
    any mix: quantized leaves are dicts {"q","s"} handled by _mm.
    """
    if dtype in ("float32", "f32"):
        return params
    if dtype in ("bfloat16", "bf16"):
        def conv(k, v):
            if isinstance(v, dict):
                return {lk: conv(lk, lv) for lk, lv in v.items()}
            return v.to(torch.bfloat16) if k in _MATMUL_KEYS or k == "embed" else v

        return {k: conv(k, v) for k, v in params.items()}
    if dtype != "int8":
        raise ValueError(f"unsupported param dtype {dtype!r}")
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = {lk: (_quant_cols(lv) if lk in _MATMUL_KEYS else lv)
                      for lk, lv in v.items()}
        elif k in _MATMUL_KEYS:
            out[k] = _quant_cols(v)
        elif k == "embed":
            a = v.abs().amax(dim=-1)     # per-row: embed is a gather
            s = torch.clamp(a, min=1e-8) / 127.0
            out[k] = {
                "q": torch.clamp(torch.round(v / s[:, None]), -127, 127).to(torch.int8),
                "s": s.to(torch.float32),
            }
        else:
            out[k] = v
    return out


def _mm(h: torch.Tensor, w, cdt: torch.dtype) -> torch.Tensor:
    """h @ w for a plain tensor or an int8 dict {"q","s"}; scales applied
    after the product (per-out-channel), activations stay in cdt. Like
    memex_tpu's, the product returns cdt."""
    if isinstance(w, dict):
        y = h @ w["q"].to(cdt)
        return (y.to(torch.float32) * w["s"]).to(cdt)
    return h @ w.to(cdt)


def _embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding gather -> f32 residual stream, any storage dtype."""
    if isinstance(embed, dict):
        x = embed["q"][tokens].to(torch.float32)
        return x * embed["s"][tokens][..., None]
    return embed[tokens].to(torch.float32)


def layer_view(layers: dict, i: int) -> dict:
    """Layer i's weights: views into the stacked tensors (int8 leaves keep
    their {"q", "s"} form)."""
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """cos, sin [B, T, 1, hd/2] of Llama's half-split rotary."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, n, hd]; positions: [B, T]."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    return _apply_rope(x, cos, sin)


def _kv_cache(cfg, batch: int = 1, device="cuda") -> dict:
    shape = (cfg.num_layers, batch, cfg.max_context, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def init_cache(cfg, batch: int = 1, device="cuda") -> dict:
    """The family's cache: [L, B, max_context, n_kv, hd] bf16 K and V for
    Llama and GPT-J, the latent cache for DeepSeek-V2."""
    return family_of(cfg).init_cache(cfg, batch=batch, device=device)


def cache_slots(cache_len, T: int, C: int, device) -> torch.Tensor:
    """The T cache rows a forward writes, from `cache_len` (a Python int,
    or a 0-d device tensor in decode, never read back). The start is
    clamped into [0, C - T] as `lax.dynamic_update_slice` clamps it, so a
    speculative step past the window overwrites the last row."""
    if isinstance(cache_len, torch.Tensor):
        start = cache_len.clamp(0, C - T)
    else:
        start = min(max(int(cache_len), 0), C - T)
    return start + torch.arange(T, device=device)


def attention_mask(positions: torch.Tensor, prefill_local: bool, C: int) -> torch.Tensor:
    """[B, T, K] key position <= query position: over the new tokens in
    prefill (K = T), over the whole cache window in decode (K = C)."""
    if prefill_local:
        kpos = positions[:, None, :]
    else:
        kpos = torch.arange(C, device=positions.device)[None, None, :]
    return kpos <= positions[:, :, None]


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, cache: dict, cache_len) -> tuple[torch.Tensor, dict]:
    """tokens [B, T] + cache up to cache_len -> (logits [B, T, V] f32, cache).

    Causal within the new tokens; full attention to cached positions
    < cache_len. Static shapes: the cache is max_context long, masked by
    position, and written in place.
    """
    cdt = _DTYPES[cfg.compute_dtype]
    B, T = tokens.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = nh // nkv
    C = cfg.max_context
    # Prefill (T > 1) only runs at cache_len = 0: attend over the new
    # tokens only, their keys round-tripped through the cache's bf16 so
    # prefill logits match the cached-decode path.
    prefill_local = T > 1
    x = _embed_lookup(params["embed"], tokens)  # residual stream f32
    cos, sin = _rope_tables(positions, hd, cfg.rope_theta)
    mask = attention_mask(positions, prefill_local, C)[:, None, None]  # [B,1,1,T,K]
    slots = cache_slots(cache_len, T, C, tokens.device)
    scale = math.sqrt(hd)

    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, C, nkv, hd] views
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps).to(cdt)
        q = _mm(h, lp["q"], cdt).reshape(B, T, nh, hd)
        k = _mm(h, lp["k"], cdt).reshape(B, T, nkv, hd)
        v = _mm(h, lp["v"], cdt).reshape(B, T, nkv, hd)
        q = _apply_rope(q.to(torch.float32), cos, sin).to(cdt)
        k = _apply_rope(k.to(torch.float32), cos, sin).to(cdt)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ck.index_copy_(1, slots, kb)
        cv.index_copy_(1, slots, vb)

        # GQA as grouped products: query heads as [nkv, rep] against K/V.
        qg = q.reshape(B, T, nkv, rep, hd).to(torch.float32)
        if prefill_local:
            keys, vals = kb.to(cdt), vb.to(cdt)
        else:
            keys, vals = ck.to(cdt), cv.to(cdt)  # [B, C, nkv, hd]
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, keys.to(torch.float32)) / scale
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cdt)
        ctx = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(torch.float32),
                           vals.to(torch.float32))
        attn_out = _mm(ctx.reshape(B, T, nh * hd).to(cdt), lp["o"], cdt)
        x = x + attn_out.to(torch.float32)

        h = _rms_norm(x, lp["ffn_norm"], cfg.rms_eps).to(cdt)
        gate = F.silu(_mm(h, lp["gate"], cdt).to(torch.float32)).to(cdt)
        up = _mm(h, lp["up"], cdt)
        ffn = _mm(gate * up, lp["down"], cdt)
        x = x + ffn.to(torch.float32)

    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = _mm(x.to(cdt), params["lm_head"], cdt)
    return logits.to(torch.float32), cache


# ---------------------------------------------------------------------------
# sampling (reference sampler chain: schema.rs:36-82: repetition penalty,
# top-k, top-p, temperature)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.7
    top_k: int = 40
    top_p: float = 0.95
    repetition_penalty: float = 1.1
    repetition_window: int = 64


def gumbel_noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from `gen`, drawn on the device, with
    jax.random.gumbel's floor on the uniform (the smallest normal f32)."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sample_token(logits: torch.Tensor, recent: torch.Tensor, sc: SamplerConfig,
                 gumbel) -> torch.Tensor:
    """logits [V]; recent [W] token ids (pad with -1) -> sampled id, a 0-d
    device tensor. `gumbel(shape)` gives the noise of the categorical
    draw: jax.random.categorical(key, x) is argmax(x + gumbel(key,
    x.shape)), so the tests can feed memex_tpu's own noise."""
    v = logits.shape[-1]
    # Repetition penalty on recent tokens: an order-free boolean scatter
    # (every write stores True; the pads go to a spare slot v). index_fill_
    # takes its value as a scalar argument: `seen[idx] = True` would copy a
    # host tensor to the device and wait for it.
    seen = torch.zeros(v + 1, dtype=torch.bool, device=logits.device).index_fill_(
        0, torch.where(recent >= 0, recent.clamp(0, v - 1), v), True)
    penalized = torch.where(
        logits > 0, logits / sc.repetition_penalty, logits * sc.repetition_penalty
    )
    logits = torch.where(seen[:v], penalized, logits)

    if sc.temperature <= 0:
        return torch.argmax(logits)          # the first maximum, as jnp.argmax
    logits = logits / sc.temperature
    if 0 < sc.top_k < v:
        # lax.top_k's order: values descending, ties to the lower index (a
        # stable descending sort; torch.topk promises no tie order).
        vals, idxs = torch.sort(logits, descending=True, stable=True)
        vals, idxs = vals[: sc.top_k], idxs[: sc.top_k]
        if sc.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) < sc.top_p            # first token always kept
            vals = torch.where(keep, vals, -1e30)
        choice = torch.argmax(vals + gumbel(vals.shape))
        return idxs.index_select(0, choice.view(1))[0]
    # top_k disabled: full-vocab nucleus fallback
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_idx = torch.sum(cum < sc.top_p)  # keep at least 1
        cutoff = sorted_logits.index_select(0, cutoff_idx.clamp(0, v - 1).view(1))
        logits = torch.where(logits < cutoff, -1e30, logits)
    return torch.argmax(logits + gumbel(logits.shape))


# ---------------------------------------------------------------------------
# generation. Two shapes over the same decode step:
#   generate():     prefill + max_new steps, one host read at the end;
#   prefill() + decode_chunk(): `chunk` steps a call, the carry (KV cache
#     etc.) stays on the device between calls, the host reads each chunk's
#     tokens (streaming).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Family:
    """What the runtime needs of one decoder family. Each family module
    exports one; families.FAMILIES holds them under the name that
    `cfg.model_family` and the TOML `[model] type` both use."""

    name: str
    config: Callable      # (model dir, TOML [model] table) -> config
    load: Callable        # (model dir, config, [model] table, device, weights) -> params
    init_params: Callable  # (config, seed=, device=) -> params drawn from the seed
    forward: Callable     # (cfg, params, tokens, positions, cache, cache_len) -> (logits, cache)
    init_cache: Callable  # (cfg, batch=, device=) -> cache
    head_at: bool = False  # forward takes `logits_at` and computes the head there alone
    takes_weights: bool = False  # load reads `weights`, the tensors already in memory
    tiny: Callable | None = None  # vocab size -> a hermetic config; None: no tiny fallback


def family_of(cfg) -> Family:
    from .families import FAMILIES  # the family modules import this one

    return FAMILIES[cfg.model_family]


def converting_loader(load_float32) -> Callable:
    """A Family.load over `load_float32(dir, cfg, device=) -> (cfg, params)`
    that converts the weights to the TOML's param_dtype (convert_params)."""
    def load(path: str, cfg, model: dict, device, weights=None) -> dict:
        params = load_float32(path, cfg, device=device)[1]
        return convert_params(params, str(model.get("param_dtype", "bfloat16")))
    return load


LLAMA = Family("llama", lambda path, model: LlamaConfig.from_model_dir(path),
               converting_loader(load_params), init_params, forward, _kv_cache,
               tiny=LlamaConfig.tiny)


def model_forward(cfg, params: dict, tokens, positions, cache, cache_len,
                  logits_at: int | torch.Tensor | None = None):
    """Family dispatch: the generation machinery below drives any decoder
    exposing the (logits, cache) contract. With `logits_at`, the logits
    of that row only ([B, 1, V]), or of a 1-D tensor of R rows ([B, R, V]):
    DeepSeek-V2 computes the head there alone, the others slice their full
    logits."""
    fam = family_of(cfg)
    if fam.head_at:
        return fam.forward(cfg, params, tokens, positions, cache, cache_len, logits_at=logits_at)
    logits, cache = fam.forward(cfg, params, tokens, positions, cache, cache_len)
    if isinstance(logits_at, int):
        logits = logits[:, logits_at:logits_at + 1]
    elif logits_at is not None:
        logits = logits[:, logits_at]
    return logits, cache


def _decode_step(cfg, params: dict, sc: SamplerConfig, eos_id: int, gen: torch.Generator):
    """One decode step shared by generate() and decode_chunk(): no value
    leaves the device."""

    def step(carry):
        cache, cur_logits, recent, pos, done = carry
        tok = sample_token(cur_logits, recent, sc,
                           lambda shape: gumbel_noise(shape, gen, cur_logits.device))
        tok = tok.masked_fill(done, eos_id)
        new_done = done | (tok == eos_id)
        logits, cache = model_forward(cfg, params, tok.view(1, 1), pos.view(1, 1), cache, pos)
        recent = torch.cat([recent[1:], tok.view(1)])
        return (cache, logits[0, 0], recent, pos + 1, new_done), tok, done

    return step


def prefill(cfg, params: dict, prompt: torch.Tensor, prompt_len: int,
            sc: SamplerConfig):
    """One forward over the padded prompt [1, P] (on the device; prompt_len
    a host int) -> the device-resident decode carry (cache, logits at the
    last prompt token, sampler window, position, done)."""
    B, P = prompt.shape
    device = prompt.device
    cache = init_cache(cfg, batch=B, device=device)
    positions = torch.arange(P, device=device)[None, :]
    # logits at the last real prompt token (an empty prompt reads the
    # last position, as memex_tpu's take_along_axis wraps -1)
    logits, cache = model_forward(cfg, params, prompt, positions, cache, 0,
                                  logits_at=(prompt_len - 1) % P)
    last = logits[0, 0]
    W = sc.repetition_window
    # seed recent with the tail of the prompt
    idx = torch.arange(W, device=device) + (prompt_len - W)
    tail = prompt[0][idx.clamp(0, P - 1)]
    recent0 = torch.where(idx >= 0, tail, -1)
    pos = torch.full((), prompt_len, dtype=torch.long, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    return (cache, last, recent0, pos, done)


def decode_chunk(cfg, params: dict, carry, sc: SamplerConfig, chunk: int,
                 gen: torch.Generator, eos_id: int = 2):
    """Advance the decode by `chunk` tokens without a host read. The carry's
    cache is updated in place (memex_tpu donates it), so the carry passed
    in is spent. Returns (carry', tokens [chunk], was_done [chunk])."""
    step = _decode_step(cfg, params, sc, eos_id, gen)
    toks, dones = [], []
    for _ in range(chunk):
        carry, tok, was_done = step(carry)
        toks.append(tok)
        dones.append(was_done)
    return carry, torch.stack(toks), torch.stack(dones)


def generate(cfg, params: dict, prompt: torch.Tensor, prompt_len: int,
             sc: SamplerConfig, max_new: int, gen: torch.Generator, eos_id: int = 2):
    """prompt [1, P] padded; returns (tokens [max_new], n_valid), both on
    the device. Early stop via the done mask: the steps run to max_new and
    n_valid counts the tokens before the first eos step. Spans
    `llm.prefill` and `llm.decode` (host), and inside a
    `METRICS.device_timing()` scope `llm.prefill_dev` and `llm.decode_dev`
    (device) with `llm.decode_tokens` counted beside the latter."""
    device = prompt.device
    with METRICS.span("llm.prefill"), METRICS.device_span("llm.prefill_dev", device):
        carry = prefill(cfg, params, prompt, prompt_len, sc)
    with METRICS.span("llm.decode"), METRICS.device_span(
            "llm.decode_dev", device, {"llm.decode_tokens": max_new}):
        _, tokens, was_done = decode_chunk(cfg, params, carry, sc, max_new, gen, eos_id)
    return tokens, torch.sum(~was_done)
