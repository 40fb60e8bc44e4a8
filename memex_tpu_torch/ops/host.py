"""Device->host fetch with one wait for all copies (port of
memex_tpu/ops/host.py).

`fetch` issues every tensor's copy before it waits for any: each CUDA
tensor is copied with `non_blocking=True` into a fresh pinned host
tensor, an event is recorded behind the copies on each source device's
current stream, and the host waits on those events once, before any
numpy view is taken. A blocking `.cpu()` per tensor would wait once per
tensor instead.

Pinned memory read before its copy has finished holds stale data and
raises nothing, so the wait comes before every `.numpy()`. The host
buffers are never reused here: PyTorch's pinned-memory cache hands a
block out again only after the copies queued into it have finished.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: widen after the copy (exact), as the
    # encoder's bfloat16 fetch does.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Copy tensors to host numpy arrays, in the order given, with their
    shapes and dtypes (bfloat16 arrives as float32). CPU tensors pass
    through as `.numpy()`; CUDA tensors are all copied before one wait."""
    hosts: list[torch.Tensor] = []
    streams: dict[torch.device, torch.cuda.Stream] = {}
    for t in tensors:
        t = t.detach()
        if t.device.type == "cpu":
            hosts.append(t)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
        streams.setdefault(t.device, torch.cuda.current_stream(t.device))
    done = []
    for stream in streams.values():
        ev = torch.cuda.Event()
        ev.record(stream)
        done.append(ev)
    for ev in done:
        ev.synchronize()
    return tuple(_host(h) for h in hosts)
