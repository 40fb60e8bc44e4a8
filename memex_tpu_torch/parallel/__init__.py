"""Parallelism toolkit (port of memex_tpu/parallel): the shard list, the
top-k merge of the sharded indexes and multi-host bring-up.

memex_tpu runs a sharded index as one SPMD program over a 1-D device mesh
(`jax.shard_map`, then an `all_gather` + `lax.top_k`). The port runs it
from one controller by default: an index holds a list of devices, one
entry per shard (an entry may repeat a device), keeps each shard's
tensors on its own device, launches every shard's scan before it fetches
anything, and merges the shards' candidates on the lead device (entry 0).
After `init_multihost` (memex_tpu's multi-host bring-up, on a
`torch.distributed` process group) there is one controller a process:
each rank holds and scans only its own shards, and the ranks all_gather
their candidates into the same merge.
"""

from .collectives import merge_topk_across
from .distributed import init_multihost
from .mesh import local_mesh, replicate, row_blocks, shard_layout

__all__ = ["init_multihost", "local_mesh", "replicate", "row_blocks", "shard_layout",
           "merge_topk_across"]
