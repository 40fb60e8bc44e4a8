"""Parallelism toolkit (port of memex_tpu/parallel): the shard list and
the top-k merge of the sharded indexes.

memex_tpu runs a sharded index as one SPMD program over a 1-D device mesh
(`jax.shard_map`, then an `all_gather` + `lax.top_k`). The port keeps the
single controller: an index holds a list of devices, one entry per shard
(an entry may repeat a device), keeps each shard's tensors on its own
device, launches every shard's scan before it fetches anything, and
merges the shards' candidates on the lead device (entry 0).
Multi-host serving (memex_tpu's `distributed.init_multihost`) is not
ported.
"""

from .collectives import merge_topk_across
from .mesh import local_mesh, replicate, row_blocks

__all__ = ["local_mesh", "replicate", "row_blocks", "merge_topk_across"]
