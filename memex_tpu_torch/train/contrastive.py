"""Contrastive fine-tuning of the MiniLM encoder (port of
memex_tpu/train/contrastive.py): symmetric InfoNCE over in-batch
negatives, clip-by-global-norm then AdamW.

Batch = (q_ids, q_mask, d_ids, d_mask), [B, L] each: row i's positive is
doc i; every other doc of the batch is a negative.

memex_tpu jits one SPMD step over its mesh: the batch is sharded by rows,
params and optimizer state are replicated, and the loss is taken over the
global batch. The port keeps the single controller: the step takes a list
of devices, one entry per row block (entries may repeat a device). Each
block is encoded on its device's replica; the embeddings are brought to
the lead device (entry 0), where the loss over the whole batch is taken,
so every row's negatives are the whole batch, as there. The replicas'
gradients are summed onto the lead device in entry order, the optimizer
steps there, and the replicas take the new params at the next step.

The step is a fixed function of its inputs on a card too: attention runs
on SDPA's math backend here (the memory-efficient kernel that CUDA picks
for float32 with a mask has a non-deterministic backward).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..models.minilm import MiniLM, MiniLMConfig
from ..parallel.mesh import row_blocks


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05  # InfoNCE temperature (sentence-transformers default scale)
    grad_clip: float = 1.0


class ClipAdamW(torch.optim.Optimizer):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay=wd))
    with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decay on
    every parameter), in optax's arithmetic:

      g <- g if |g| < grad_clip else g / |g| * grad_clip   (|g| over all params)
      mu <- (1 - b1) g + b1 mu ;  nu <- (1 - b2) g^2 + b2 nu ;  count += 1
      p <- p + -lr (mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + eps) + wd p)

    Its state is optax's ScaleByAdamState(count, mu, nu): `count` in the
    one param group, `mu` and `nu` in each parameter's state. The clip is
    not torch.nn.utils.clip_grad_norm_, which divides by |g| + 1e-6. No
    step reads the card back: the clip's branch is a select on the device.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults

    def __init__(self, params, lr: float, weight_decay: float, grad_clip: float):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                                      count=0))
        if len(self.param_groups) != 1:
            raise ValueError("ClipAdamW clips over one global norm: pass one param group")
        for p in self.param_groups[0]["params"]:
            self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    @property
    def params(self) -> list[torch.Tensor]:
        return self.param_groups[0]["params"]

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @count.setter
    def count(self, value: int) -> None:
        self.param_groups[0]["count"] = int(value)

    def moments(self, key: str) -> list[torch.Tensor]:
        return [self.state[p][key] for p in self.params]

    @torch.no_grad()
    def step(self, closure=None):
        g_ = self.param_groups[0]
        b1, b2, eps = self.B1, self.B2, self.EPS
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        # clip_by_global_norm: select(|g| < max, g, g / |g| * max), as
        # g / d * f with (d, f) = (1, 1) or (|g|, max) chosen on the device.
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        keep = norm < g_["grad_clip"]
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * g_["grad_clip"]))
        # scale_by_adam
        mu, nu = self.moments("mu"), self.moments("nu")
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        self.count = self.count + 1
        # optax's bias corrections are float32 powers of the int32 count.
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        # add_decayed_weights, scale_by_learning_rate, apply_updates
        torch._foreach_add_(updates, torch._foreach_mul(params, g_["weight_decay"]))
        torch._foreach_mul_(updates, -g_["lr"])
        torch._foreach_add_(params, updates)


def init_train_state(cfg: MiniLMConfig, params, tc: TrainConfig,
                     device: torch.device | str | None = None) -> dict:
    """{"params": float32 MiniLM, "opt": ClipAdamW, "step": int}. `params`
    is a MiniLM (trained in place) or a state dict (params_from_numpy's)."""
    if isinstance(params, MiniLM):
        model = params
    else:
        model = MiniLM(cfg)
        model.load_state_dict(params)
    if device is not None:
        model = model.to(device)
    opt = ClipAdamW(model.parameters(), tc.learning_rate, tc.weight_decay, tc.grad_clip)
    return {"params": model, "opt": opt, "step": 0}


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float):
    """Symmetric InfoNCE over in-batch negatives. Embeddings unit-norm."""
    logits = (q_emb @ d_emb.T) / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qd = F.cross_entropy(logits, labels, reduction="none")
    loss_dq = F.cross_entropy(logits.T, labels, reduction="none")
    loss = 0.5 * (loss_qd + loss_dq).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return loss, acc


def _indexed(device) -> torch.device:
    """`cuda` -> `cuda:<current>`, so entries compare equal to a tensor's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_train_step(cfg: MiniLMConfig, tc: TrainConfig,
                    devices: list[torch.device | str] | None = None):
    """Returns `(state, batch) -> (state, metrics)` over `devices` (default:
    the params' device alone). The batch's rows split into len(devices)
    equal blocks; the state is updated in place on the lead device."""
    replicas: dict[torch.device, MiniLM] = {}

    def step(state, batch):
        model, opt = state["params"], state["opt"]
        lead = next(model.parameters()).device
        devs = [_indexed(d) for d in devices] if devices else [lead]
        if devs[0] != lead:
            raise ValueError(f"the params live on {lead}, the lead entry is {devs[0]}")
        # One replica a device; the lead device's is the model itself.
        for d in dict.fromkeys(devs):
            if d == lead:
                continue
            if d not in replicas:
                replicas[d] = copy.deepcopy(model).to(d)
            with torch.no_grad():
                for rp, p in zip(replicas[d].parameters(), model.parameters()):
                    rp.copy_(p)
                    rp.grad = None
        opt.zero_grad(set_to_none=True)

        def rows(key):
            return row_blocks(torch.as_tensor(batch[key]), devs)

        q_ids, q_mask, d_ids, d_mask = (rows(k) for k in ("q_ids", "q_mask", "d_ids", "d_mask"))
        with sdpa_kernel(SDPBackend.MATH):
            q_parts, d_parts = [], []
            for p, d in enumerate(devs):
                enc = model if d == lead else replicas[d]
                b = q_ids[p].shape[0]
                emb = enc(torch.cat([q_ids[p], d_ids[p]]), torch.cat([q_mask[p], d_mask[p]]))
                q_parts.append(emb[:b].to(lead))
                d_parts.append(emb[b:].to(lead))
            loss, acc = info_nce_loss(torch.cat(q_parts), torch.cat(d_parts), tc.temperature)
            loss.backward()
        for d in dict.fromkeys(devs):
            if d != lead:
                torch._foreach_add_([p.grad for p in model.parameters()],
                                    [rp.grad.to(lead) for rp in replicas[d].parameters()])
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step
