"""Share of the traced window in which no kernel, copy or set ran on the
card (torch.profiler's device activity)."""

from perfbench.layer_metrics import _share


def read(obs):
    return _share.idle(obs)
