"""Multi-host bring-up (port of memex_tpu/parallel/distributed.py).

memex_tpu joins its processes with `jax.distributed.initialize`, after
which `jax.devices()` spans every process and a sharded index is one SPMD
program over all of them. The port joins them in one `torch.distributed`
process group instead: every process (rank) is a controller of its own
shards, and the sharded indexes all_gather their candidates over the
group (parallel/collectives.py). As there, every rank must be called with
the same arguments in the same order.

The transport is NCCL when the runtime device is a CUDA card and gloo on
the CPU. JAX picks its own; here `MEMEX_DIST_BACKEND` may override the
choice (NCCL refuses two ranks on one card: gloo runs them).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..log import get_logger

logger = get_logger(__name__)

# A collective that waits longer than this raises: a rank whose peer went
# its own way fails instead of hanging.
TIMEOUT_S = 300.0


def backend_for(device: torch.device | str | None = None) -> str:
    """`MEMEX_DIST_BACKEND`, else nccl for a CUDA device (default: CUDA
    when a card is visible) and gloo otherwise."""
    chosen = os.environ.get("MEMEX_DIST_BACKEND")
    if chosen:
        return chosen
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, *,
                   device: torch.device | str | None = None) -> bool:
    """Join the process group from args or MEMEX_COORDINATOR (host:port of
    rank 0's rendezvous) / MEMEX_NUM_PROCESSES / MEMEX_PROCESS_ID. Returns
    True once joined, False (doing nothing) without a coordinator."""
    coordinator = coordinator or os.environ.get("MEMEX_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("MEMEX_NUM_PROCESSES", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("MEMEX_PROCESS_ID", "0")))
    backend = backend_for(device)
    if backend == "nccl":
        # The rank's first visible card; a launcher gives each rank its
        # own cards with CUDA_VISIBLE_DEVICES.
        torch.cuda.set_device(0)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    logger.info("torch.distributed initialized: process %d/%d via %s (%s)",
                process_id, num_processes, coordinator, backend)
    return True


def default_group():
    """The process group a sharded store spans: the world group once
    init_multihost has run, else None (one controller)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None
