"""Decode's share of HBM bandwidth: the bytes the window's decode steps
must read at least (arith_llm.decode_bytes: 2.45B bf16 parameters a step
and the latent cache before each step's position) over the window's
decode device seconds (`llm.decode_dev`) x 3.35 TB/s. A lower bound on
what is read, so it cannot pass 100%."""

from perfbench import arith, arith_llm


def read(obs):
    us = (obs.get("counters") or {}).get("llm.decode_dev_us", 0)
    asks = obs.get("asks")
    if not us or not asks:
        return None
    return 100.0 * arith_llm.decode_bytes(asks) / (us / 1e6 * arith.HBM_BYTES_PER_S)
