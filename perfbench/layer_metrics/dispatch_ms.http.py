"""Mean host milliseconds the batcher spends dispatching a search batch
(tokenize, launch the encoder and the scan, under the store lock):
`batcher.search.dispatch_us` over `batcher.search.batches` in the window."""

from perfbench.layer_metrics import _share


def read(obs):
    return _share.dispatch_ms(obs)
