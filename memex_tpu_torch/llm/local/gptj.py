"""GPT-J family decoder in PyTorch (port of memex_tpu/llm/local/gptj.py),
the reference's second local-LLM family (schema.rs model_type llama|gptj).

Architecture differences vs Llama (model.py):
  - LayerNorm (with bias) instead of RMSNorm; ONE ln per block;
  - parallel residual: x += attn(ln(x)) + mlp(ln(x));
  - rotary on the first `rotary_dim` head dims only, with the GPT-J
    "rotate every two" (interleaved) convention, not Llama's half-split;
  - MHA (no GQA), no qkv/out biases, mlp fc biases, gelu_new (tanh);
  - lm_head has a bias.

Same layer-stacked parameter layout, in-place static KV cache and
float32 attention products as model.py, and the same (logits, cache)
contract, so generate/prefill/decode_chunk drive either family.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .model import (
    _DTYPES,
    Family,
    _embed_lookup,
    _kv_cache,
    _mm,
    _normal,
    attention_mask,
    cache_slots,
    converting_loader,
    hf_tensor,
    layer_view,
    read_safetensors,
    stack_layers,
)


@dataclass(frozen=True)
class GptJConfig:
    vocab_size: int = 50400
    hidden_size: int = 4096
    num_layers: int = 28
    num_heads: int = 16
    rotary_dim: int = 64
    intermediate_size: int = 16384
    max_context: int = 2048
    ln_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    model_family: str = "gptj"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:  # MHA; lets init_cache treat both families alike
        return self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "GptJConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, num_layers=2,
                   num_heads=4, rotary_dim=16, intermediate_size=256,
                   max_context=256, compute_dtype="float32")

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "GptJConfig":
        with open(os.path.join(model_dir, "config.json"), "r", encoding="utf-8") as fh:
            cfg = json.load(fh)
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["n_embd"],
            num_layers=cfg["n_layer"],
            num_heads=cfg["n_head"],
            rotary_dim=cfg.get("rotary_dim") or cfg["n_embd"] // cfg["n_head"],
            intermediate_size=cfg.get("n_inner") or 4 * cfg["n_embd"],
            max_context=min(cfg.get("n_positions", 2048), 4096),
            ln_eps=cfg.get("layer_norm_epsilon", 1e-5),
        )


def init_params(cfg: GptJConfig, seed: int = 0, device="cuda") -> dict:
    """Random float32 weights from `seed`, drawn on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "embed": _normal(gen, (cfg.vocab_size, H), device),
        "ln_f_scale": const((H,), 1.0),
        "ln_f_bias": const((H,), 0.0),
        "lm_head": _normal(gen, (H, cfg.vocab_size), device),
        "lm_head_bias": const((cfg.vocab_size,), 0.0),
        "layers": {
            "ln_scale": const((L, H), 1.0),
            "ln_bias": const((L, H), 0.0),
            "q": _normal(gen, (L, H, H), device),
            "k": _normal(gen, (L, H, H), device),
            "v": _normal(gen, (L, H, H), device),
            "o": _normal(gen, (L, H, H), device),
            "fc_in": _normal(gen, (L, H, I), device),
            "fc_in_b": const((L, I), 0.0),
            "fc_out": _normal(gen, (L, I, H), device),
            "fc_out_b": const((L, H), 0.0),
        },
    }


_HF = {
    "ln_scale": ("ln_1.weight", False),
    "ln_bias": ("ln_1.bias", False),
    "q": ("attn.q_proj.weight", True),
    "k": ("attn.k_proj.weight", True),
    "v": ("attn.v_proj.weight", True),
    "o": ("attn.out_proj.weight", True),
    "fc_in": ("mlp.fc_in.weight", True),
    "fc_in_b": ("mlp.fc_in.bias", False),
    "fc_out": ("mlp.fc_out.weight", True),
    "fc_out_b": ("mlp.fc_out.bias", False),
}


def load_params(model_dir: str, cfg: GptJConfig | None = None,
                device="cuda") -> tuple[GptJConfig, dict]:
    """Load HF GPT-J safetensors (transformer.h.* naming), float32 on
    `device`."""
    if cfg is None:
        cfg = GptJConfig.from_model_dir(model_dir)
    tensors = read_safetensors(model_dir)
    return cfg, {
        "embed": hf_tensor(tensors, "transformer.wte.weight", device),
        "ln_f_scale": hf_tensor(tensors, "transformer.ln_f.weight", device),
        "ln_f_bias": hf_tensor(tensors, "transformer.ln_f.bias", device),
        "lm_head": hf_tensor(tensors, "lm_head.weight", device, transpose=True),
        "lm_head_bias": (hf_tensor(tensors, "lm_head.bias", device)
                         if "lm_head.bias" in tensors
                         else torch.zeros(cfg.vocab_size, dtype=torch.float32,
                                          device=device)),
        "layers": stack_layers(tensors, _HF, "transformer.h.", cfg.num_layers, device),
    }


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _rotary_tables(positions: torch.Tensor, rotary_dim: int):
    """cos, sin [B, T, 1, rotary_dim/2] of GPT-J's interleaved rotary."""
    half = rotary_dim // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32,
                                            device=positions.device) * 2 / rotary_dim))
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    rotary_dim = 2 * cos.shape[-1]
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1 = rot[..., 0::2]  # even dims
    x2 = rot[..., 1::2]  # odd dims
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    # interleave back: [..., half, 2] -> [..., rotary_dim]
    rot_out = torch.stack([r1, r2], dim=-1).reshape(rot.shape)
    return torch.cat([rot_out, rest], dim=-1)


def _rotary_every_two(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """GPT-J interleaved rotary on the first rotary_dim head dims.
    x: [B, T, n, hd]; positions: [B, T]."""
    cos, sin = _rotary_tables(positions, rotary_dim)
    return _apply_rotary(x, cos, sin)


def forward(cfg: GptJConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, cache: dict, cache_len) -> tuple[torch.Tensor, dict]:
    """Same contract as model.forward: (logits [B, T, V] f32, cache), the
    cache written in place."""
    cdt = _DTYPES[cfg.compute_dtype]
    B, T = tokens.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    C = cfg.max_context
    prefill_local = T > 1  # cache empty: attend over the new tokens only
    x = _embed_lookup(params["embed"], tokens)  # residual stream f32
    cos, sin = _rotary_tables(positions, cfg.rotary_dim)
    mask = attention_mask(positions, prefill_local, C)[:, None]  # [B,1,T,K]
    slots = cache_slots(cache_len, T, C, tokens.device)
    scale = math.sqrt(hd)

    for i in range(cfg.num_layers):
        lp = layer_view(params["layers"], i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = _layer_norm(x, lp["ln_scale"], lp["ln_bias"], cfg.ln_eps).to(cdt)
        q = _mm(h, lp["q"], cdt).reshape(B, T, nh, hd)
        k = _mm(h, lp["k"], cdt).reshape(B, T, nh, hd)
        v = _mm(h, lp["v"], cdt).reshape(B, T, nh, hd)
        q = _apply_rotary(q.to(torch.float32), cos, sin).to(cdt)
        k = _apply_rotary(k.to(torch.float32), cos, sin).to(cdt)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ck.index_copy_(1, slots, kb)
        cv.index_copy_(1, slots, vb)
        if prefill_local:
            keys, vals = kb.to(cdt), vb.to(cdt)
        else:
            keys, vals = ck.to(cdt), cv.to(cdt)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                              keys.to(torch.float32)) / scale
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(cdt)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                           vals.to(torch.float32))
        attn_out = _mm(ctx.reshape(B, T, nh * hd).to(cdt), lp["o"], cdt)

        # parallel residual: the mlp runs on the SAME ln output as attention
        m = F.gelu((_mm(h, lp["fc_in"], cdt) + lp["fc_in_b"].to(cdt)).to(torch.float32),
                   approximate="tanh").to(cdt)
        mlp_out = _mm(m, lp["fc_out"], cdt) + lp["fc_out_b"].to(cdt)
        x = x + attn_out.to(torch.float32) + mlp_out.to(torch.float32)

    x = _layer_norm(x, params["ln_f_scale"], params["ln_f_bias"], cfg.ln_eps)
    logits = _mm(x.to(cdt), params["lm_head"], cdt) + params["lm_head_bias"]
    return logits.to(torch.float32), cache


GPTJ = Family("gptj", lambda path, model: GptJConfig.from_model_dir(path),
              converting_loader(load_params), init_params, forward, _kv_cache,
              tiny=GptJConfig.tiny)
