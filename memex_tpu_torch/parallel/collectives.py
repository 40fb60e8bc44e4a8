"""The cross-shard top-k merge and the collectives of a multi-controller
index (port of memex_tpu/parallel/collectives.py).

memex_tpu all_gathers the shards' [Q, kk] candidates into a shard-major
[Q, P * kk] row and takes `lax.top_k`, which prefers the lower position
on equal values. On one controller the candidates are copied to the lead
device and concatenated in shard order; under a process group (one
controller a rank, parallel/distributed.py) each rank concatenates its
own shards' and the group all_gathers them, rank-major, which is global
shard order. A stable descending sort then takes the top k on every rank,
so ties resolve as there (CUDA `torch.topk` leaves their order open) and
every rank holds the same hits.

Transport: on NCCL the tensors stay on the card; on gloo they pass through
the host, as memex_tpu's cross-host (DCN) hop does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.topk import _stable_topk


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """t where the group's transport reads it: the host for gloo, the
    rank's card for NCCL."""
    if dist.get_backend(group) == "gloo":
        return t.cpu()
    return t if t.is_cuda else t.cuda()


def all_gather_cat(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's t (equal shapes) concatenated along dim in rank order,
    on t's device."""
    src = _wire(t, group).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def from_rank0(t: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's t on every rank (t's shape and dtype; its values are read
    only on rank 0), on t's device. None: one controller, t as it is."""
    if group is None:
        return t
    buf = _wire(t, group).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return buf.to(t.device)


def sum_across(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's t. A gather writes the slots of
    its own shards into a zeroed buffer: the sum is then every rank's
    slots, exactly (x + 0 is x)."""
    if group is None:
        return t
    buf = _wire(t, group).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def check_same(value, group, what: str):
    """value, after checking that every rank of the group holds an equal
    one (any picklable object); raises on the first rank to see them
    differ. None: one controller, nothing to check."""
    if group is not None:
        seen: list = [None] * dist.get_world_size(group)
        dist.all_gather_object(seen, value, group=group)
        if any(v != value for v in seen):
            raise RuntimeError(f"the ranks disagree on {what}: {seen}")
    return value


def gather_candidates(vals: torch.Tensor, idx: torch.Tensor, group):
    """Every rank's [Q, w] float32 vals and integer idx, concatenated in
    rank order, through one all_gather: both ride one int32 tensor, the
    values and the int64 ids by their bits, and come back bit for bit."""
    q, w = vals.shape
    packed = torch.cat([vals.view(torch.int32), idx.to(torch.int64).view(torch.int32)], dim=1)
    parts = all_gather_cat(packed, group).view(q, -1, 3 * w)
    return (parts[..., :w].reshape(q, -1).view(torch.float32),
            parts[..., w:].reshape(q, -1).view(torch.int64).to(idx.dtype))


def merge_topk_across(vals: list[torch.Tensor], idx: list[torch.Tensor], k: int,
                      device: torch.device | str, group=None):
    """This controller's shards' candidates (vals[p], idx[p]: [Q, kk]
    each, idx a global id, in shard order) -> (vals [Q, k], idx [Q, k]) on
    `device`, the same on every rank of `group`. On one controller only
    device-to-device copies: nothing here waits for the host."""
    all_vals = torch.cat([v.to(device) for v in vals], dim=1)
    all_idx = torch.cat([i.to(device) for i in idx], dim=1)
    if group is not None:
        all_vals, all_idx = gather_candidates(all_vals, all_idx, group)
    mvals, order = _stable_topk(all_vals, k)
    return mvals, torch.gather(all_idx, 1, order.long())
