"""Device milliseconds a decode step in the window: the program's
`llm.decode_dev` microseconds (CUDA events around a generation's decode
steps) over `llm.decode_tokens`, the steps those events cover."""


def read(obs):
    c = obs.get("counters") or {}
    n = c.get("llm.decode_tokens", 0)
    return c.get("llm.decode_dev_us", 0) / 1e3 / n if n else None
