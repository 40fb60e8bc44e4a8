"""Mean queries a search batch in the window: `batcher.search.items` over
`batcher.search.batches` (serve/batcher.py's METRICS counters)."""

from perfbench.layer_metrics import _share


def read(obs):
    return _share.fill(obs)
