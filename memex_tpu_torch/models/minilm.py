"""MiniLM sentence encoder in PyTorch (port of memex_tpu/models/minilm.py).

all-MiniLM-L12-v2 geometry: BERT embeddings + LayerNorm, 12 post-LN
encoder layers (384 hidden, 12 heads, 1536 FFN, exact GELU), then a
masked mean over the tokens and L2 normalisation. The numerics follow the
JAX forward: dense layers run in the compute dtype (bf16 by default) on a
residual stream held in that dtype, while LayerNorm, residual adds, GELU
and pooling run in float32. Embeddings and LayerNorm parameters stay
float32.

Weights load from and save to an HF-format directory (`model.safetensors`
with the BERT tensor names, `config.json`, optional `vocab.txt`), read
and written with numpy, so a checkpoint moves between this package and
memex_tpu unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    compute_dtype: str = "bfloat16"  # dense-layer dtype; LN/embeddings stay f32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "MiniLMConfig":
        with open(os.path.join(model_dir, "config.json"), "r", encoding="utf-8") as fh:
            cfg = json.load(fh)
        return cls(
            vocab_size=cfg.get("vocab_size", 30522),
            hidden_size=cfg.get("hidden_size", 384),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 1536),
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        )


# HF BERT tensor names (per layer, without ".weight"/".bias") -> the
# module's attribute names. HF Linear weights are [out, in], as nn.Linear's.
_HF_LAYER_MAP = {
    "attention.self.query": "q",
    "attention.self.key": "k",
    "attention.self.value": "v",
    "attention.output.dense": "o",
    "attention.output.LayerNorm": "attn_ln",
    "intermediate.dense": "ffn_in",
    "output.dense": "ffn_out",
    "output.LayerNorm": "ffn_ln",
}
_HF_EMBED_MAP = {
    "embeddings.word_embeddings": "word",
    "embeddings.position_embeddings": "position",
    "embeddings.token_type_embeddings": "token_type",
    "embeddings.LayerNorm": "ln",
}
# memex_tpu pytree leaf names (per layer) -> (attribute, parameter).
_JAX_LAYER_MAP = {
    "q_w": ("q", "weight"), "q_b": ("q", "bias"),
    "k_w": ("k", "weight"), "k_b": ("k", "bias"),
    "v_w": ("v", "weight"), "v_b": ("v", "bias"),
    "o_w": ("o", "weight"), "o_b": ("o", "bias"),
    "attn_ln_scale": ("attn_ln", "weight"), "attn_ln_bias": ("attn_ln", "bias"),
    "ffn_in_w": ("ffn_in", "weight"), "ffn_in_b": ("ffn_in", "bias"),
    "ffn_out_w": ("ffn_out", "weight"), "ffn_out_b": ("ffn_out", "bias"),
    "ffn_ln_scale": ("ffn_ln", "weight"), "ffn_ln_bias": ("ffn_ln", "bias"),
}


class _Layer(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.q, self.k, self.v, self.o = (nn.Linear(H, H) for _ in range(4))
        self.attn_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(H, I)
        self.ffn_out = nn.Linear(I, H)
        self.ffn_ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class MiniLM(nn.Module):
    """`forward(ids, mask) -> [B, H]` unit vectors (float32)."""

    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, H)
        self.position = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type = nn.Embedding(cfg.type_vocab_size, H)
        self.ln = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))

    def init_random(self, seed: int = 0) -> "MiniLM":
        """Deterministic random init, as memex_tpu's init_params: weights
        and embeddings N(0, 0.02^2), biases 0, LayerNorm 1/0. The numbers
        differ from the JAX init for the same seed."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif name.split(".")[-2].endswith("ln"):
                    p.fill_(1.0)
                else:
                    p.copy_(0.02 * torch.randn(p.shape, generator=g))
        return self

    def cast_to_compute(self) -> "MiniLM":
        """Dense layers (weights and biases) to the compute dtype; embeddings
        and LayerNorm stay float32 (memex_tpu's cast_params_to_compute)."""
        cdt = self.cfg.torch_compute_dtype
        for layer in self.layers:
            for lin in (layer.q, layer.k, layer.v, layer.o, layer.ffn_in, layer.ffn_out):
                lin.to(cdt)
        return self

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = cfg.torch_compute_dtype
        B, L = ids.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        pos = torch.arange(L, device=ids.device)
        x = (self.word(ids.long()) + self.position(pos)[None]
             + self.token_type.weight[0][None, None])
        x = _ln(x, self.ln).to(cdt)
        # Boolean key mask, broadcast over heads and query positions.
        key_mask = mask.bool()[:, None, None, :]

        def heads(t):
            return t.reshape(B, L, nh, hd).transpose(1, 2)

        for layer in self.layers:
            q, k, v = heads(layer.q(x)), heads(layer.k(x)), heads(layer.v(x))
            ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
            ctx = ctx.transpose(1, 2).reshape(B, L, nh * hd).to(cdt)
            x = _ln(x.float() + layer.o(ctx).float(), layer.attn_ln).to(cdt)
            h = F.gelu(layer.ffn_in(x).float(), approximate="none").to(cdt)
            x = _ln(x.float() + layer.ffn_out(h).float(), layer.ffn_ln).to(cdt)
        x = x.float()
        m = mask.float()[:, :, None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _hf_tensors(model: MiniLM) -> dict[str, np.ndarray]:
    """Module parameters under their HF names, as float32 numpy arrays."""
    out = {}
    for hf, attr in _HF_EMBED_MAP.items():
        mod = getattr(model, attr)
        out[f"{hf}.weight"] = mod.weight
        if attr == "ln":
            out[f"{hf}.bias"] = mod.bias
    for i, layer in enumerate(model.layers):
        for hf, attr in _HF_LAYER_MAP.items():
            mod = getattr(layer, attr)
            out[f"encoder.layer.{i}.{hf}.weight"] = mod.weight
            out[f"encoder.layer.{i}.{hf}.bias"] = mod.bias
    return {k: np.ascontiguousarray(v.detach().float().cpu().numpy()) for k, v in out.items()}


def load_params(model_dir: str, cfg: MiniLMConfig | None = None,
                device: torch.device | str = "cpu") -> tuple[MiniLMConfig, MiniLM]:
    """Load an HF-format BERT checkpoint into a float32 MiniLM on `device`."""
    if cfg is None:
        cfg = MiniLMConfig.from_model_dir(model_dir)
    from safetensors import safe_open

    tensors: dict[str, np.ndarray] = {}
    with safe_open(os.path.join(model_dir, "model.safetensors"), framework="numpy") as f:
        for name in f.keys():
            tensors[name.removeprefix("bert.")] = f.get_tensor(name)
    model = MiniLM(cfg)
    expected = _hf_tensors(model)
    missing = sorted(set(expected) - set(tensors))
    if missing:
        raise KeyError(f"checkpoint {model_dir} lacks {missing[:4]}...")
    _load_hf(model, {k: tensors[k] for k in expected})
    return cfg, model.to(device)


def _load_hf(model: MiniLM, tensors: dict[str, np.ndarray]) -> None:
    with torch.no_grad():
        for hf, attr in _HF_EMBED_MAP.items():
            mod = getattr(model, attr)
            mod.weight.copy_(torch.from_numpy(np.asarray(tensors[f"{hf}.weight"], np.float32)))
            if attr == "ln":
                mod.bias.copy_(torch.from_numpy(np.asarray(tensors[f"{hf}.bias"], np.float32)))
        for i, layer in enumerate(model.layers):
            for hf, attr in _HF_LAYER_MAP.items():
                mod = getattr(layer, attr)
                for p in ("weight", "bias"):
                    arr = np.asarray(tensors[f"encoder.layer.{i}.{hf}.{p}"], np.float32)
                    getattr(mod, p).copy_(torch.from_numpy(arr))


def save_params(model_dir: str, cfg: MiniLMConfig, model: MiniLM,
                vocab: list[str] | None = None) -> None:
    """Export to HF format (model.safetensors + config.json [+ vocab.txt]),
    the inverse of load_params and the same files memex_tpu writes."""
    from safetensors.numpy import save_file

    os.makedirs(model_dir, exist_ok=True)
    save_file(_hf_tensors(model), os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({
            "model_type": "bert",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": "gelu",
        }, fh)
    if vocab is not None:
        with open(os.path.join(model_dir, "vocab.txt"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(vocab) + "\n")


def params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """memex_tpu's parameter pytree (numpy leaves, dense weights [in, out])
    -> a state dict for `MiniLM` (dense weights [out, in])."""
    emb = tree["embeddings"]
    sd = {
        "word.weight": emb["word"],
        "position.weight": emb["position"],
        "token_type.weight": emb["token_type"],
        "ln.weight": emb["ln_scale"],
        "ln.bias": emb["ln_bias"],
    }
    for i, lp in enumerate(tree["layers"]):
        for leaf, (attr, p) in _JAX_LAYER_MAP.items():
            arr = np.asarray(lp[leaf], np.float32)
            if p == "weight" and not attr.endswith("ln"):
                arr = arr.T
            sd[f"layers.{i}.{attr}.{p}"] = arr
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
