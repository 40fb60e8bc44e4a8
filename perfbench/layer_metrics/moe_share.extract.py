"""Share of prefill device time in the MoE blocks: the program's
`llm.moe_dev` (CUDA events around each MoE layer of a prefill: router,
the grouped expert products, the shared experts) over `llm.prefill_dev`."""


def read(obs):
    c = obs.get("counters") or {}
    prefill = c.get("llm.prefill_dev_us", 0)
    return c.get("llm.moe_dev_us", 0) / prefill if prefill and c.get("llm.moe_dev_n") else None
