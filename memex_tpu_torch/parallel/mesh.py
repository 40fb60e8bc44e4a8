"""Shard lists and the helpers that place a tensor on them (port of
memex_tpu/parallel/mesh.py: a 1-D mesh becomes a list of torch devices,
one entry per shard). Under a process group the list spans every rank,
and the entries of the other ranks' shards are None: the helpers skip
them."""

from __future__ import annotations

import torch
import torch.distributed as dist


def local_mesh(device: torch.device | str, n: int | None = None) -> list[torch.device]:
    """The shard list for `device`: every visible CUDA card (the first n
    with n) for a CUDA device, else n entries (default 1) of `device`.
    memex_tpu's `local_mesh(axis, n)` spans the first n of jax.devices()."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devices if n is None else devices[:n]
    return [device] * (1 if n is None else n)


def shard_layout(devices: list, group=None) -> tuple[list[torch.device | None], range]:
    """(the global shard list, this controller's own shards in it) for an
    index over `devices`. One controller (group None) owns every entry.
    Under a process group a rank's devices are its own shards, global
    shard g = rank * P_local + p (the rank-major order of memex_tpu's
    jax.devices() across processes), and the other ranks' entries are
    None. The ranks exchange P_local once, here: it must be the same on
    every rank, as memex_tpu's mesh has one shape on every host."""
    devices = [torch.device(d) for d in devices]
    if group is None:
        return devices, range(len(devices))
    counts: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, len(devices), group=group)
    if len(set(counts)) > 1:
        raise ValueError(f"ranks hold different shard counts {counts}: every rank must "
                         f"hold as many")
    rank, n = dist.get_rank(group), len(devices)
    layout: list[torch.device | None] = [None] * (len(counts) * n)
    layout[rank * n : (rank + 1) * n] = devices
    return layout, range(rank * n, (rank + 1) * n)


def replicate(t: torch.Tensor, devices: list) -> list[torch.Tensor | None]:
    """One copy of t per entry, on that entry's device (None for a None
    entry); entries that repeat a device share one copy."""
    copies: dict[torch.device, torch.Tensor] = {}
    return [None if d is None else copies.setdefault(d, t.to(d)) for d in devices]


def row_blocks(t: torch.Tensor, devices: list) -> list[torch.Tensor | None]:
    """t split into len(devices) contiguous row blocks of equal size, block
    p on entry p's device (None for a None entry; memex_tpu's row sharding
    P(axis, None); the row count must divide evenly, as there)."""
    p = len(devices)
    if t.shape[0] % p:
        raise ValueError(f"{t.shape[0]} rows do not split evenly over {p} shards")
    return [None if d is None else blk.to(d) for blk, d in zip(torch.chunk(t, p), devices)]
