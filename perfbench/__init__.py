"""The benchmark of memex_tpu_torch on one NVIDIA H100.

`python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of the root BENCHMARK.json once and prints one JSON line.
Everything a cell needs is found by name: `configs/<config>.json`,
`traffic/<cell>.json` (its `kind` names a module of `drivers/`) and
`layer_metrics/<metric>.py`. Nothing here imports jax or memex_tpu, and
`reference/` imports nothing of memex_tpu_torch.
"""
