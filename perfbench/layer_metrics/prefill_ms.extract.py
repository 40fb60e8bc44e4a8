"""Mean device milliseconds of a prefill in the window: the program's
`llm.prefill_dev` (CUDA events around `prefill` in `generate`, counted
after the generation's own host read) over its count."""

from perfbench.layer_metrics import _span


def read(obs):
    return _span.mean_ms(obs, "llm.prefill_dev")
