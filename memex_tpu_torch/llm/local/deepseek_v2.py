"""DeepSeek-V2 family decoder in PyTorch: latent attention (MLA) and
sparse experts beside shared ones, the local LLM's third family.

The equations follow DeepSeek's `modeling_deepseek.py` (HF remote code of
deepseek-ai/DeepSeek-V2-Lite), for a config without `q_lora_rank`:

  - attention: q = x W_q, split per head into nope (qk_nope_head_dim) and
    pe (qk_rope_head_dim); [c_kv, k_pe] = x W_kva, c_kv RMS-normed;
    [k_nope, v] = c_kv W_kvb per head; one roped k_pe shared by every
    head. RoPE acts on q_pe and k_pe after HF's interleave-to-half
    permutation, with YaRN frequencies (a linear ramp over
    `yarn_find_correction_range(beta_fast, beta_slow, ...)` blends the
    interpolated and the extrapolated ones) and the cos/sin scale
    get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim). The
    softmax scale is q_head_dim^-0.5 * get_mscale(factor, mscale_all_dim)^2;
  - the first `first_k_dense_replace` layers are a dense SwiGLU; every
    later one is a MoE: a float32 softmax router, greedy top-k, the
    weights renormalised only with `norm_topk_prob`, else scaled by
    `routed_scaling_factor`, and the shared experts (one SwiGLU of width
    moe_intermediate_size x n_shared_experts) added once;
  - untied lm_head.

Two attention paths over one latent cache [L, B, C, kv_lora_rank +
qk_rope_head_dim] (c_kv and the roped k_pe a position):
  - prefill (T > 1, at cache_len 0) expands the latent into K and V and
    runs causal `scaled_dot_product_attention` over the new tokens;
  - decode (T = 1) absorbs W_UK into the query, attends over the latent
    cache in float32 and applies W_UV to the attended latent.

Layout (matmul weights [in, out], as model.py): "layers" holds the
attention and norms of every layer stacked [L, ...]; "dense" the
leading dense SwiGLUs [K, ...]; "moe" the expert layers [L - K, ...],
the routed experts [L - K, E, in, out] and the router [L - K, H, E] in
float32.

Departures from modeling_deepseek.py:
  - projections in the compute dtype; norms, RoPE, the router, the
    decode path's attention products and the residual stream in float32
    (HF rounds cos/sin, the residual and the combined MoE output to the
    model dtype);
  - the latent cache holds c_kv after its norm in the compute dtype, and
    prefill expands K and V from that same rounded latent, so prefill and
    decode read alike;
  - prefill attention is `scaled_dot_product_attention` in the compute
    dtype, V zero-padded to the query width (as HF's flash path does);
  - the routed sum is weighted in float32 and added to the shared
    experts' output in float32;
  - `forward(..., logits_at=i)` computes the head at row i only (or at
    the rows of a 1-D index tensor): a 32k prefill's full float32 logits
    would be 13 GB.

Weights load from HF safetensors, or from HF-named tensors already in
memory (`load_params`), or are drawn from a seed on the device
(`init_params`), straight into the storage dtype. `moe_tap` lets a
checker see each MoE layer's routing and sums.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...metrics import METRICS
from .model import (
    _DTYPES,
    _apply_rope,
    _embed_lookup,
    _mm,
    _rms_norm,
    attention_mask,
    cache_slots,
)


@dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    rope_factor: float = 40.0          # 1.0: plain RoPE (no rope_scaling)
    rope_original_max: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    rms_eps: float = 1e-6
    max_context: int = 4096            # the deployment's window
    compute_dtype: str = "bfloat16"
    model_family: str = "deepseek_v2"

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def softmax_scale(self) -> float:
        m = yarn_get_mscale(self.rope_factor, self.mscale_all_dim)
        return self.q_head_dim ** -0.5 * m * m

    @property
    def rope_mscale(self) -> float:
        return (yarn_get_mscale(self.rope_factor, self.mscale)
                / yarn_get_mscale(self.rope_factor, self.mscale_all_dim))

    @classmethod
    def from_hf(cls, hf: dict, max_context: int | None = None,
                compute_dtype: str = "bfloat16") -> "DeepseekV2Config":
        """From the keys of HF's DeepSeek-V2 config.json. `max_context` is
        the deployment's window (default: the published positions, at most
        4,096). Raises ValueError on what this port does not compute."""
        only = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax",
                "moe_layer_freq": 1, "attention_bias": False, "hidden_act": "silu",
                "tie_word_embeddings": False}
        for key, want in only.items():
            got = hf.get(key)
            if got is not None and got != want:  # absent or null: the default
                raise ValueError(f"deepseek_v2: {key} = {got!r} is not supported (only {want!r})")
        rs = hf.get("rope_scaling") or {}
        if rs and rs.get("type", rs.get("rope_type")) != "yarn":
            raise ValueError(f"deepseek_v2: rope_scaling {rs!r} is not supported (only yarn)")
        positions = int(hf.get("max_position_embeddings", 4096))
        return cls(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"], num_heads=hf["num_attention_heads"],
            qk_nope_head_dim=hf["qk_nope_head_dim"], qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"], kv_lora_rank=hf["kv_lora_rank"],
            intermediate_size=hf["intermediate_size"],
            moe_intermediate_size=hf["moe_intermediate_size"],
            n_routed_experts=hf["n_routed_experts"], n_shared_experts=hf["n_shared_experts"],
            num_experts_per_tok=hf["num_experts_per_tok"],
            first_k_dense_replace=hf.get("first_k_dense_replace", 0),
            norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
            routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rope_factor=float(rs.get("factor", 1.0)),
            rope_original_max=int(rs.get("original_max_position_embeddings", positions)),
            beta_fast=float(rs.get("beta_fast", 32)), beta_slow=float(rs.get("beta_slow", 1)),
            mscale=float(rs.get("mscale", 1.0)),
            mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
            rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
            max_context=int(max_context or min(positions, 4096)),
            compute_dtype=compute_dtype,
        )

    @classmethod
    def from_model_dir(cls, model_dir: str, max_context: int | None = None,
                       compute_dtype: str = "bfloat16") -> "DeepseekV2Config":
        with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as fh:
            return cls.from_hf(json.load(fh), max_context, compute_dtype)


# ---------------------------------------------------------------------------
# YaRN (modeling_deepseek.py's yarn_* helpers)
# ---------------------------------------------------------------------------


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations: float, dim: int, base: float,
                             max_position: int) -> float:
    return (dim * math.log(max_position / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_find_correction_range(low_rot: float, high_rot: float, dim: int, base: float,
                               max_position: int) -> tuple[int, int]:
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """[qk_rope_head_dim / 2] float32 inverse frequencies: the interpolated
    (/ factor) and extrapolated ones blended by 1 - linear ramp over the
    correction range; plain RoPE's at factor 1."""
    dim = cfg.qk_rope_head_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (cfg.rope_theta ** exps)
    if cfg.rope_factor <= 1:
        return freq_extra
    freq_inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** exps)
    low, high = yarn_find_correction_range(cfg.beta_fast, cfg.beta_slow, dim, cfg.rope_theta,
                                           cfg.rope_original_max)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    return freq_inter * (1 - extra) + freq_extra * extra


def rope_tables(cfg: DeepseekV2Config, positions: torch.Tensor):
    """cos, sin [B, T, 1, qk_rope_head_dim / 2], times the YaRN cos/sin scale."""
    angles = positions[..., None].to(torch.float32) * yarn_inv_freq(cfg, positions.device)
    m = cfg.rope_mscale
    return (torch.cos(angles) * m)[:, :, None, :], (torch.sin(angles) * m)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF's interleave-to-half permutation ([.., d/2, 2] -> [.., 2, d/2]),
    then the half-split rotation. x [B, T, n, d] float32."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    return _apply_rope(x, cos, sin)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: DeepseekV2Config, seed: int = 0, device="cuda",
                dtype: str = "bfloat16") -> dict:
    """Random weights from `seed`, drawn on `device` one layer at a time in
    float32 (0.02 * N(0, 1), as model.init_params) and stored in `dtype`
    (norms and the router stay float32), so that the float32 draw of the
    whole model never sits on the device at once."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    wdt = _DTYPES[dtype]

    def normal(*shape):
        out = torch.empty(shape, dtype=wdt, device=device)
        flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out.view(1, *shape)
        for block in flat:  # one [in, out] matrix at a time
            block.copy_(torch.randn(block.shape, generator=gen, device=device,
                                    dtype=torch.float32).mul_(0.02))
        return out

    def router(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    K, M, E = cfg.first_k_dense_replace, cfg.n_moe_layers, cfg.n_routed_experts
    nh, r, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Ie, Is = cfg.moe_intermediate_size, cfg.moe_intermediate_size * cfg.n_shared_experts
    return {
        "embed": normal(V, H),
        "final_norm": ones(H),
        "lm_head": normal(H, V),
        "layers": {
            "attn_norm": ones(L, H),
            "q": normal(L, H, nh * cfg.q_head_dim),
            "kv_a": normal(L, H, r + dr),
            "kv_norm": ones(L, r),
            "kv_b": normal(L, r, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "o": normal(L, nh * cfg.v_head_dim, H),
            "ffn_norm": ones(L, H),
        },
        "dense": {
            "gate": normal(K, H, cfg.intermediate_size),
            "up": normal(K, H, cfg.intermediate_size),
            "down": normal(K, cfg.intermediate_size, H),
        },
        "moe": {
            "router": router(M, H, E),
            "gate": normal(M, E, H, Ie),
            "up": normal(M, E, H, Ie),
            "down": normal(M, E, Ie, H),
            "shared_gate": normal(M, H, Is),
            "shared_up": normal(M, H, Is),
            "shared_down": normal(M, Is, H),
        },
    }


_HF_ATTN = {
    "attn_norm": "input_layernorm.weight",
    "q": "self_attn.q_proj.weight",
    "kv_a": "self_attn.kv_a_proj_with_mqa.weight",
    "kv_norm": "self_attn.kv_a_layernorm.weight",
    "kv_b": "self_attn.kv_b_proj.weight",
    "o": "self_attn.o_proj.weight",
    "ffn_norm": "post_attention_layernorm.weight",
}
_HF_MLP = {"gate": "gate_proj.weight", "up": "up_proj.weight", "down": "down_proj.weight"}
_FLOAT32 = frozenset({"attn_norm", "kv_norm", "ffn_norm", "final_norm", "router"})


class _Checkpoint:
    """Tensors of an HF safetensors checkpoint (one file or an index of
    shards), read one at a time."""

    def __init__(self, model_dir: str):
        from safetensors import safe_open

        index = os.path.join(model_dir, "model.safetensors.index.json")
        files = ["model.safetensors"]
        if os.path.exists(index):
            with open(index, encoding="utf-8") as fh:
                files = sorted(set(json.load(fh)["weight_map"].values()))
        self._where = {}
        for fname in files:
            f = safe_open(os.path.join(model_dir, fname), framework="pt")
            for name in f.keys():
                self._where[name] = f

    def get(self, name: str) -> torch.Tensor:
        return self._where[name].get_tensor(name)


def load_params(model_dir: str, cfg: DeepseekV2Config | None = None, device="cuda",
                dtype: str = "bfloat16", tensors=None) -> tuple[DeepseekV2Config, dict]:
    """HF DeepSeek-V2 safetensors (`model.layers.N.self_attn.*`, layer 0's
    `mlp.{gate,up,down}_proj`, `mlp.gate`, `mlp.experts.N.*`,
    `mlp.shared_experts.*`), [out, in] weights transposed, each tensor
    cast to its storage dtype as it lands on `device` in its preallocated
    stack. `tensors`, anything whose `get(name)` gives a tensor by its HF
    name (a checkpoint already in memory), is read in place of the dir's
    safetensors."""
    cfg = cfg or DeepseekV2Config.from_model_dir(model_dir)
    ck = tensors if tensors is not None else _Checkpoint(model_dir)
    device = torch.device(device)
    wdt = _DTYPES[dtype]

    def land(ours: str, t: torch.Tensor, transpose: bool = True) -> torch.Tensor:
        t = t.T if transpose and t.dim() == 2 else t
        return t.to(device=device, dtype=torch.float32 if ours in _FLOAT32 else wdt)

    def stack(ours: str, names: list) -> torch.Tensor:
        """One HF name a slot; [layer][expert] nested for the routed experts."""
        flat = [n for row in names for n in (row if isinstance(row, list) else [row])]
        if not flat:
            return torch.empty(0, dtype=wdt, device=device)
        first = land(ours, ck.get(flat[0]))
        lead = (len(names), len(names[0])) if isinstance(names[0], list) else (len(names),)
        out = torch.empty((*lead, *first.shape), dtype=first.dtype, device=device)
        slots = out.view(-1, *first.shape)
        slots[0] = first
        del first
        for j, n in enumerate(flat[1:], 1):
            slots[j] = land(ours, ck.get(n))
        return out

    def layer(i: int, hf: str) -> str:
        return f"model.layers.{i}.{hf}"

    L, K, E = cfg.num_layers, cfg.first_k_dense_replace, cfg.n_routed_experts
    moe_layers = range(K, L)
    params = {
        "embed": land("embed", ck.get("model.embed_tokens.weight"), transpose=False),
        "final_norm": land("final_norm", ck.get("model.norm.weight")),
        "lm_head": land("lm_head", ck.get("lm_head.weight")),
        "layers": {k: stack(k, [layer(i, hf) for i in range(L)]) for k, hf in _HF_ATTN.items()},
        "dense": {k: stack(k, [layer(i, "mlp." + hf) for i in range(K)])
                  for k, hf in _HF_MLP.items()},
        "moe": {"router": stack("router", [layer(i, "mlp.gate.weight") for i in moe_layers])},
    }
    for k, hf in _HF_MLP.items():
        params["moe"][k] = stack(
            k, [[layer(i, f"mlp.experts.{e}.{hf}") for e in range(E)] for i in moe_layers])
        params["moe"]["shared_" + k] = stack(
            k, [layer(i, f"mlp.shared_experts.{hf}") for i in moe_layers])
    return cfg, params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def init_cache(cfg: DeepseekV2Config, batch: int = 1, device="cuda") -> dict:
    """The latent cache: c_kv and the roped k_pe of every position, in the
    compute dtype (1.02 GB at 27 layers x 32,768 positions in bf16)."""
    shape = (cfg.num_layers, batch, cfg.max_context, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return {"latent": torch.zeros(shape, dtype=_DTYPES[cfg.compute_dtype], device=device)}


def _attention(cfg: DeepseekV2Config, lp: dict, h: torch.Tensor, cos, sin,
               latent: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor | None,
               cdt: torch.dtype) -> torch.Tensor:
    """One layer's MLA on the normed input h [B, T, H]; writes the new
    positions' latent into `latent` [B, C, r + dr]. `mask` [B, 1, T, C]
    (decode: the cache positions each query sees; None in prefill)."""
    B, T, _ = h.shape
    nh, dn, dr, dv, r = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
    q = _mm(h, lp["q"], cdt).view(B, T, nh, dn + dr)
    q_nope = q[..., :dn]
    q_pe = apply_rope(q[..., dn:].to(torch.float32), cos, sin).to(cdt)
    kv = _mm(h, lp["kv_a"], cdt)
    c = _rms_norm(kv[..., :r], lp["kv_norm"], cfg.rms_eps).to(cdt)
    k_pe = apply_rope(kv[..., None, r:].to(torch.float32), cos, sin)[:, :, 0].to(cdt)
    latent.index_copy_(1, slots, torch.cat([c, k_pe], dim=-1))
    if T > 1:
        # Prefill: K and V expanded from the latent, causal over the new tokens.
        kvb = _mm(c, lp["kv_b"], cdt).view(B, T, nh, dn + dv)
        k = torch.cat([kvb[..., :dn], k_pe[:, :, None].expand(B, T, nh, dr)], dim=-1)
        v = F.pad(kvb[..., dn:], (0, dn + dr - dv))
        out = F.scaled_dot_product_attention(
            torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), is_causal=True, scale=cfg.softmax_scale)
        out = out[..., :dv].transpose(1, 2).reshape(B, T, nh * dv)
    else:
        # Decode: W_UK absorbed into the query, attention over the latent
        # cache, W_UV applied to the attended latent; float32 products.
        w = lp["kv_b"].view(r, nh, dn + dv).to(torch.float32)
        q_abs = torch.einsum("btnd,rnd->btnr", q_nope.to(torch.float32), w[..., :dn])
        lat = latent.to(torch.float32)                                   # [B, C, r + dr]
        scores = (torch.einsum("btnr,bcr->bntc", q_abs, lat[..., :r])
                  + torch.einsum("btnd,bcd->bntc", q_pe.to(torch.float32), lat[..., r:]))
        probs = torch.softmax(torch.where(mask, scores * cfg.softmax_scale, -1e30), dim=-1)
        ctx = torch.einsum("bntc,bcr->btnr", probs, lat[..., :r])
        out = torch.einsum("btnr,rnd->btnd", ctx, w[..., dn:]).reshape(B, T, nh * dv).to(cdt)
    return _mm(out, lp["o"], cdt)


def _swiglu(x: torch.Tensor, gate, up, down, cdt: torch.dtype) -> torch.Tensor:
    g = F.silu(_mm(x, gate, cdt).to(torch.float32)).to(cdt)
    return _mm(g * _mm(x, up, cdt), down, cdt)


_TAPS: list = []


@contextlib.contextmanager
def moe_tap(fn):
    """Within the scope every MoE layer calls fn(layer, x, weights, ids,
    routed, shared): its input rows x [N, H], the router's weights [N, k]
    float32 and expert ids [N, k], the weighted routed sum [N, H] float32
    and the shared experts' output [N, H]. For a checker; no timed path
    opens one."""
    _TAPS.append(fn)
    try:
        yield
    finally:
        _TAPS.remove(fn)


def route(cfg: DeepseekV2Config, x: torch.Tensor, router: torch.Tensor):
    """(weights [N, k] float32, expert ids [N, k]): a float32 softmax over
    every expert, greedy top-k, not renormalised unless norm_topk_prob."""
    scores = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    w, idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        w = w * cfg.routed_scaling_factor
    return w, idx


def _moe(cfg: DeepseekV2Config, mp: dict, j: int, h: torch.Tensor, cdt: torch.dtype,
         grouped: bool) -> torch.Tensor:
    """MoE layer j on h [B, T, H]: the routed experts' weighted sum plus the
    shared experts, float32. `grouped` (prefill): tokens sorted by expert,
    one product an expert on its rows (the expert sizes are read back, as
    HF's moe_infer does); else (decode) the chosen experts' weights
    gathered and applied in batched products, with no host read."""
    B, T, H = h.shape
    x = h.reshape(B * T, H)
    w, idx = route(cfg, x, mp["router"][j])
    k = cfg.num_experts_per_tok
    gate, up, down = mp["gate"][j], mp["up"][j], mp["down"][j]
    if grouped:
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        xs = x[order // k]
        out_sorted = torch.empty_like(xs)
        start = 0
        for e, n in enumerate(torch.bincount(flat, minlength=cfg.n_routed_experts).tolist()):
            if n:
                out_sorted[start:start + n] = _swiglu(xs[start:start + n], gate[e], up[e],
                                                      down[e], cdt)
            start += n
        out = torch.empty_like(out_sorted)
        out[order] = out_sorted
    else:
        flat = idx.reshape(-1)
        xs = x.repeat_interleave(k, dim=0)[:, None]                        # [N k, 1, H]
        g = F.silu(torch.bmm(xs, gate[flat].to(cdt)).to(torch.float32)).to(cdt)
        out = torch.bmm(g * torch.bmm(xs, up[flat].to(cdt)), down[flat].to(cdt))[:, 0]
    routed = (out.view(B * T, k, H).to(torch.float32) * w[..., None]).sum(dim=1)
    shared = _swiglu(x, mp["shared_gate"][j], mp["shared_up"][j], mp["shared_down"][j], cdt)
    for tap in _TAPS:
        tap(cfg.first_k_dense_replace + j, x, w, idx, routed, shared)
    return (routed + shared.to(torch.float32)).view(B, T, H)


def forward(cfg: DeepseekV2Config, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor, cache: dict, cache_len,
            logits_at: int | torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """model.forward's contract: tokens [B, T] + the cache up to cache_len ->
    (logits [B, T, V] float32, cache written in place); with `logits_at`,
    logits [B, 1, V] of that row only, or [B, R, V] at a 1-D tensor of R
    rows. Prefill (T > 1) runs at cache_len 0.
    The MoE blocks of a prefill are timed on the device as `llm.moe_dev`
    (where a `METRICS.device_timing()` scope is open)."""
    cdt = _DTYPES[cfg.compute_dtype]
    B, T = tokens.shape
    prefill = T > 1
    x = _embed_lookup(params["embed"], tokens)  # residual stream float32
    cos, sin = rope_tables(cfg, positions)
    slots = cache_slots(cache_len, T, cfg.max_context, tokens.device)
    mask = None if prefill else attention_mask(positions, False, cfg.max_context)[:, None]
    attn, dense, moe = params["layers"], params["dense"], params["moe"]
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in attn.items()}
        h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps).to(cdt)
        x = x + _attention(cfg, lp, h, cos, sin, cache["latent"][i], slots, mask,
                           cdt).to(torch.float32)
        h = _rms_norm(x, lp["ffn_norm"], cfg.rms_eps).to(cdt)
        j = i - cfg.first_k_dense_replace
        if j < 0:
            x = x + _swiglu(h, dense["gate"][i], dense["up"][i], dense["down"][i],
                            cdt).to(torch.float32)
        elif prefill:
            with METRICS.device_span("llm.moe_dev", x.device):
                x = x + _moe(cfg, moe, j, h, cdt, grouped=True)
        else:
            x = x + _moe(cfg, moe, j, h, cdt, grouped=False)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    if logits_at is not None:
        x = x[:, logits_at:logits_at + 1] if isinstance(logits_at, int) else x[:, logits_at]
    return _mm(x.to(cdt), params["lm_head"], cdt).to(torch.float32), cache
