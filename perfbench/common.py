"""What every driver shares: the run's context, seeds, the device's name
and power limit, the program's runtime, and the guard against JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# Whole top-level module names that may not be loaded where the result is
# printed: the port's name begins with "memex_tpu", so compare whole names.
FORBIDDEN = ("jax", "jaxlib", "flax", "memex_tpu")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    cell: dict            # the BENCHMARK.json workload entry
    config: dict          # configs/<config>.json, rehearsal sizes applied
    traffic: dict         # traffic/<cell>.json, rehearsal sizes applied
    seed: int
    seconds: float
    trace: bool
    device: str           # "cuda" or "cpu" (rehearsal)
    tmp: str              # scratch directory of this run, under TMPDIR
    t_start: float        # perf_counter at process start


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, from the run's seed and tags."""
    words = [abs(int(seed)), int(seed < 0)] + [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_info(device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def make_runtime(ctx: Ctx, model_dir: str):
    """The program's runtime on the run's device: SQLite and the vector
    store under the run's scratch directory, the encoder from the
    benchmark's checkpoint through the program's normal loader."""
    from memex_tpu_torch.config import Settings
    from memex_tpu_torch.runtime import TorchRuntime

    uri = ctx.config["store"]["uri"].format(dir=os.path.join(ctx.tmp, "vectors"))
    settings = Settings(db_uri=f"sqlite://{ctx.tmp}/memex.db", vector_uri=uri,
                        embedding_model=model_dir,
                        upload_dir=os.path.join(ctx.tmp, "uploads"))
    return TorchRuntime(settings, device=ctx.device)


def free_runtime(rt, collection: str) -> None:
    """Drop the program's state (batcher, store, encoder) and give the
    device memory back, before the reference runs."""
    import gc

    import torch
    from memex_tpu_torch.store.registry import _REGISTRY

    if rt._batcher is not None:
        rt._batcher.close()
    for mb in (rt._encode_batcher, rt._add_batcher):
        if mb is not None:
            mb.close()
    _REGISTRY.drop(rt.settings.vector_uri, collection)
    rt._engine = rt._batcher = rt._encode_batcher = rt._add_batcher = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank: the smallest value
    with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        return float("nan")
    rank = max(1, int(np.ceil(q / 100.0 * len(v))))
    return float(v[rank - 1])


def counter_delta(before: dict, after: dict) -> dict:
    keys = set(before) | set(after)
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def log(msg: str) -> None:
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)
