"""Device-resident vector indexes (port of memex_tpu/index): the flat and
IVF tiers on one device, and their sharded forms over a list of devices."""

from .flat import FlatIndex
from .ivf import IVFIndex
from .sharded import ShardedFlatIndex
from .sharded_ivf import ShardedIVFIndex

__all__ = ["FlatIndex", "ShardedFlatIndex", "IVFIndex", "ShardedIVFIndex"]
