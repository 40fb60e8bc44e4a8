"""The ingest step's share of the bf16 peak over the window: the encoder's
operations on the real tokens of every window whose document completed
in it (each window attending over its own length), over window seconds x
989 TFLOP/s."""

from perfbench import arith


def read(obs):
    lengths = obs.get("window_tokens")
    if not lengths:
        return None
    return 100.0 * arith.encoder_flops(lengths) / (obs["window_s"]
                                                   * arith.PEAK_OPS_PER_S["bf16"])
