"""Prefill's share of the bf16 peak: DeepSeek-V2-Lite's operations on the
real prompt ids of the window's asks (arith_llm.prefill_flops: 2 x 2.24B
matmul parameters an id with 6 routed experts, and MLA's causal
products) over the window's prefill device seconds (`llm.prefill_dev`)
x 989 TFLOP/s."""

from perfbench import arith, arith_llm


def read(obs):
    us = (obs.get("counters") or {}).get("llm.prefill_dev_us", 0)
    asks = obs.get("asks")
    if not us or not asks:
        return None
    return 100.0 * arith_llm.prefill_flops([n for n, _ in asks]) / (
        us / 1e6 * arith.PEAK_OPS_PER_S["bf16"])
