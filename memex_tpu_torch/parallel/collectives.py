"""The cross-shard top-k merge (port of memex_tpu/parallel/collectives.py).

memex_tpu all_gathers the shards' [Q, kk] candidates into a shard-major
[Q, P * kk] row and takes `lax.top_k`, which prefers the lower position
on equal values. Here the candidates are copied to the lead device and
concatenated in shard order, and a stable descending sort takes the top
k, so ties resolve as there (CUDA `torch.topk` leaves their order open).
"""

from __future__ import annotations

import torch

from ..ops.topk import _stable_topk


def merge_topk_across(vals: list[torch.Tensor], idx: list[torch.Tensor], k: int,
                      device: torch.device | str):
    """Shard p's candidates (vals[p], idx[p]: [Q, kk] each, idx a global
    id) -> (vals [Q, k], idx [Q, k]) on `device`. Device-to-device copies
    only: nothing here waits for the host."""
    all_vals = torch.cat([v.to(device) for v in vals], dim=1)
    all_idx = torch.cat([i.to(device) for i in idx], dim=1)
    mvals, order = _stable_topk(all_vals, k)
    return mvals, torch.gather(all_idx, 1, order.long())
