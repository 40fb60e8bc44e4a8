"""Plain float32 DeepSeek-V2 forward: the reference the DeepSeek cell's
program is held to, and the one the port's CPU tests compare with.

Equations of DeepSeek's `modeling_deepseek.py` (deepseek-ai/DeepSeek-V2-
Lite's remote code) for a config without `q_lora_rank`, written out from
the HF config's keys: latent attention (q split into nope and pe parts;
[c_kv, k_pe] = x W_kva with c_kv RMS-normed; [k_nope, v] = c_kv W_kvb; one
roped k_pe for every head; YaRN frequencies and cos/sin scale; softmax
scale q_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2); leading dense
SwiGLU layers, then MoE layers (float32 softmax router, greedy top-k,
renormalised only with norm_topk_prob, else times routed_scaling_factor,
plus the shared experts once); untied head.

Plain `torch` in float32 with TF32 off: no cache, no batching, no kernel.
Attention is computed in query blocks over the whole causal prefix, and
the weights are upcast a layer (an expert) at a time from whatever dtype
they are stored in, so that the reference fits beside the program on one
card. Departures from modeling_deepseek.py: everything in float32 (HF
rounds activations to the model dtype), and the head is computed at the
asked rows only.

Weights: `w(name)` gives a tensor by its name in HF's checkpoint
([out, in] matmul weights): `model.embed_tokens.weight`, `model.norm.weight`,
`lm_head.weight`, and under `model.layers.N.`: `input_layernorm`,
`self_attn.{q_proj,kv_a_proj_with_mqa,kv_a_layernorm,kv_b_proj,o_proj}`,
`post_attention_layernorm`, `mlp.{gate,up,down}_proj` (the dense layers),
`mlp.gate` (the router), `mlp.experts.E.{gate,up,down}_proj` and
`mlp.shared_experts.{gate,up,down}_proj`, each `.weight`.
"""

from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def inv_freq(hf: dict, device=None) -> torch.Tensor:
    """YaRN inverse frequencies (plain RoPE's without rope_scaling)."""
    dim, base = hf["qk_rope_head_dim"], float(hf.get("rope_theta", 10000.0))
    rs = hf.get("rope_scaling") or {}
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    factor = float(rs.get("factor", 1.0))
    if factor <= 1:
        return extra
    inter = 1.0 / (factor * base ** exps)
    orig = rs.get("original_max_position_embeddings", hf.get("max_position_embeddings"))

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr_dim(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def scales(hf: dict) -> tuple[float, float]:
    """(softmax scale, cos/sin scale)."""
    rs = hf.get("rope_scaling") or {}
    factor = float(rs.get("factor", 1.0))
    m_all = _mscale(factor, float(rs.get("mscale_all_dim", 0.0)))
    qd = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
    return qd ** -0.5 * m_all * m_all, _mscale(factor, float(rs.get("mscale", 1.0))) / m_all


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, n, d]: pairs (2i, 2i+1) moved to (i, d/2 + i), then
    x * cos + rotate_half(x) * sin with cos, sin [T, 1, d] (freqs twice)."""
    T, n, d = x.shape
    x = x.view(T, n, d // 2, 2).transpose(2, 3).reshape(T, n, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def _lin(x: torch.Tensor, w, name: str) -> torch.Tensor:
    return x @ w(name).float().T


def _swiglu(x: torch.Tensor, w, pre: str) -> torch.Tensor:
    g = torch.nn.functional.silu(_lin(x, w, pre + "gate_proj.weight"))
    return _lin(g * _lin(x, w, pre + "up_proj.weight"), w, pre + "down_proj.weight")


def _attention(hf: dict, w, pre: str, h: torch.Tensor, cos, sin, block: int) -> torch.Tensor:
    T = h.shape[0]
    nh, dn, dr, dv, r = (hf["num_attention_heads"], hf["qk_nope_head_dim"],
                         hf["qk_rope_head_dim"], hf["v_head_dim"], hf["kv_lora_rank"])
    eps = float(hf.get("rms_norm_eps", 1e-6))
    soft, _ = scales(hf)
    a = pre + "self_attn."
    q = _lin(h, w, a + "q_proj.weight").view(T, nh, dn + dr)
    kv = _lin(h, w, a + "kv_a_proj_with_mqa.weight")
    c = _rms(kv[:, :r], w(a + "kv_a_layernorm.weight"), eps)
    k_pe = _rope(kv[:, None, r:], cos, sin)                       # [T, 1, dr]
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    kvb = _lin(c, w, a + "kv_b_proj.weight").view(T, nh, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe.expand(T, nh, dr)], dim=-1)
    v = kvb[..., dn:]
    out = torch.empty(T, nh, dv, dtype=torch.float32, device=h.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        scores = torch.einsum("qnd,knd->nqk", q[s:e], k[:e]) * soft
        keys = torch.arange(e, device=h.device)
        causal = keys[None, :] <= keys[s:e, None]
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        out[s:e] = torch.einsum("nqk,knd->qnd", probs, v[:e])
    return _lin(out.reshape(T, nh * dv), w, a + "o_proj.weight")


def moe(hf: dict, w, layer: int, h: torch.Tensor):
    """MoE layer `layer` on normed rows h [N, H] float32: (expert ids
    [N, k] in the router's order, the weighted routed sum [N, H], the
    shared experts' output [N, H])."""
    no_tf32()
    k = hf["num_experts_per_tok"]
    pre = f"model.layers.{layer}.mlp."
    scores = torch.softmax(_lin(h, w, pre + "gate.weight"), dim=-1)
    wts, idx = torch.topk(scores, k, dim=-1)
    if k > 1 and hf.get("norm_topk_prob", False):
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    else:
        wts = wts * float(hf.get("routed_scaling_factor", 1.0))
    y = torch.zeros_like(h)
    for e in range(hf["n_routed_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], w, pre + f"experts.{e}.")
            y.index_add_(0, rows, out * wts[rows, slot][:, None])
    return idx, y, _swiglu(h, w, pre + "shared_experts.")


def logits(hf: dict, w, ids, rows, block: int = 512) -> torch.Tensor:
    """Float32 logits [len(rows), V] at positions `rows` of the sequence
    `ids` (positions 0..T-1), computed over the whole causal prefix."""
    no_tf32()
    embed = w("model.embed_tokens.weight")
    dev = embed.device
    ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
    rows = torch.as_tensor(rows, dtype=torch.long, device=dev)
    T = ids.shape[0]
    eps = float(hf.get("rms_norm_eps", 1e-6))
    _, cs = scales(hf)
    ang = torch.arange(T, dtype=torch.float32, device=dev)[:, None] * inv_freq(hf, dev)
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]
    cos, sin = torch.cos(ang) * cs, torch.sin(ang) * cs
    K = hf.get("first_k_dense_replace", 0)
    x = embed[ids].float()
    del embed
    with torch.no_grad():
        for i in range(hf["num_hidden_layers"]):
            pre = f"model.layers.{i}."
            x = x + _attention(hf, w, pre, _rms(x, w(pre + "input_layernorm.weight"), eps),
                               cos, sin, block)
            h = _rms(x, w(pre + "post_attention_layernorm.weight"), eps)
            if i < K:
                x = x + _swiglu(h, w, pre + "mlp.")
            else:
                _, routed, shared = moe(hf, w, i, h)
                x = x + routed + shared
        x = _rms(x[rows], w("model.norm.weight"), eps)
        return _lin(x, w, "lm_head.weight")
