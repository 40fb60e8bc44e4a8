"""all-MiniLM-L12-v2 in plain float32 PyTorch, TF32 off.

BERT embeddings (word + position + token type 0) and LayerNorm, then
post-LN encoder layers (softmax attention with a key mask, exact GELU
FFN), a masked mean over the tokens and L2 normalisation, as
sentence-transformers' model card describes. The weights are a dict of
float32 tensors under the HF BERT names, the same tensors the benchmark
writes into the checkpoint the program loads.
"""

from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _dense(x, p, name):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


@torch.no_grad()
def encode(p: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, L] ids and mask on the weights' device -> [B, H] float32 unit vectors."""
    no_tf32()
    B, L = ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = H // nh, cfg["layer_norm_eps"]
    x = (p["embeddings.word_embeddings.weight"][ids.long()]
         + p["embeddings.position_embeddings.weight"][:L][None]
         + p["embeddings.token_type_embeddings.weight"][0][None, None])
    x = _ln(x, p["embeddings.LayerNorm.weight"], p["embeddings.LayerNorm.bias"], eps)
    bias = torch.where(mask.bool(), 0.0, -math.inf)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."

        def heads(t):
            return t.reshape(B, L, nh, hd).transpose(1, 2)

        q = heads(_dense(x, p, pre + "attention.self.query"))
        k = heads(_dense(x, p, pre + "attention.self.key"))
        v = heads(_dense(x, p, pre + "attention.self.value"))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(B, L, H)
        x = _ln(x + _dense(ctx, p, pre + "attention.output.dense"),
                p[pre + "attention.output.LayerNorm.weight"],
                p[pre + "attention.output.LayerNorm.bias"], eps)
        h = _dense(x, p, pre + "intermediate.dense")
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        x = _ln(x + _dense(h, p, pre + "output.dense"),
                p[pre + "output.LayerNorm.weight"], p[pre + "output.LayerNorm.bias"], eps)
    m = mask.float()[:, :, None]
    pooled = (x * m).sum(1) / m.sum(1).clamp_min(1e-9)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def encode_ids(p: dict, cfg: dict, seqs: list[list[int]], pad: int,
               block: int = 256) -> torch.Tensor:
    """Token id lists -> [N, H] float32 unit vectors, in blocks of `block`
    sequences sorted by length (each block padded to its longest)."""
    dev = p["embeddings.word_embeddings.weight"].device
    out = torch.empty((len(seqs), cfg["hidden_size"]), dtype=torch.float32, device=dev)
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i]))
    for s in range(0, len(order), block):
        idx = order[s : s + block]
        L = max(len(seqs[i]) for i in idx)
        ids = torch.full((len(idx), L), pad, dtype=torch.int64)
        mask = torch.zeros((len(idx), L), dtype=torch.int64)
        for r, i in enumerate(idx):
            ids[r, : len(seqs[i])] = torch.tensor(seqs[i])
            mask[r, : len(seqs[i])] = 1
        out[torch.tensor(idx, device=dev)] = encode(p, cfg, ids.to(dev), mask.to(dev))
    return out
