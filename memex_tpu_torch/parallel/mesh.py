"""Shard lists and the helpers that place a tensor on them (port of
memex_tpu/parallel/mesh.py: a 1-D mesh becomes a list of torch devices,
one entry per shard)."""

from __future__ import annotations

import torch


def local_mesh(device: torch.device | str, n: int | None = None) -> list[torch.device]:
    """The shard list for `device`: every visible CUDA card (the first n
    with n) for a CUDA device, else n entries (default 1) of `device`.
    memex_tpu's `local_mesh(axis, n)` spans the first n of jax.devices()."""
    device = torch.device(device)
    if device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devices if n is None else devices[:n]
    return [device] * (1 if n is None else n)


def replicate(t: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """One copy of t per entry, on that entry's device; entries that repeat
    a device share one copy."""
    copies: dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(d, t.to(d)) for d in devices]


def row_blocks(t: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """t split into len(devices) contiguous row blocks of equal size, block
    p on entry p's device (memex_tpu's row sharding P(axis, None); the
    row count must divide evenly, as there)."""
    p = len(devices)
    if t.shape[0] % p:
        raise ValueError(f"{t.shape[0]} rows do not split evenly over {p} shards")
    return [blk.to(d) for blk, d in zip(torch.chunk(t, p), devices)]
