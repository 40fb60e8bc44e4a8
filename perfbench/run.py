"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--device cuda|cpu]

--trace 0 prints the cell's end-to-end metrics, --trace 1 its per-layer
metrics (read by `layer_metrics/<name>.py` from the window's counters and
a profiler window). `--device cpu` rehearses the cell at the sizes under
`rehearsal` in its files, on the program's plain paths, and reports every
metric as "not measured". Without a card the run exits 2 and prints no
result. The last lines of standard error name each number compared with
its limit; the last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from .common import HERE, ROOT, Ctx, forbidden_modules, load_json, log, power_limit_w  # noqa: E402


def _env() -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a checkout builds; nothing that loads JAX."""
    build = os.path.join(ROOT, "build")
    os.environ["MEMEX_COMPILE_CACHE"] = os.path.join(build, "memex_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "perfbench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "perfbench", "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("MEMEX_PROFILE", None)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, config, traffic) of the named workload, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic


def reader(name: str):
    """The per-layer metric's reader: `read(obs)` of `layer_metrics/<name>.py`."""
    path = os.path.join(HERE, "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The traffic kind's driver, `drivers/<kind>.py`."""
    if not os.path.exists(os.path.join(HERE, "drivers", kind + ".py")):
        raise SystemExit(f"no driver for traffic kind {kind!r}")
    return importlib.import_module(f"perfbench.drivers.{kind}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def compose(bench: dict, cell: dict, out: dict, trace: bool, device: str) -> dict:
    """The result line's metrics from a driver's outcome."""
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if not applies(m, cell["name"]):
                continue
            value = reader(m["name"])(out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if not applies(m, cell["name"]):
                continue
            value = out["setup_s"] if m["name"] == "setup_s" else out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device == "cpu":
        metrics = {k: {"value": "not measured", "unit": v["unit"]} for k, v in metrics.items()}
    return metrics


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number against its limit (a reading at or under its
    limit passes; NaN and infinity fail)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        passed = value is not None and math.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value if value is None or math.isfinite(value) else str(value),
                        "limit": limit}
    return ok, checks


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _env()
    bench_path = os.path.join(os.getcwd(), "BENCHMARK.json")
    if not os.path.exists(bench_path):
        print(f"no BENCHMARK.json in {os.getcwd()}", file=sys.stderr)
        return 2
    bench = load_json(bench_path)
    cell, config, traffic = load_cell(bench, args.workload)
    if args.device == "cpu":
        config = _merge(config, config.get("rehearsal", {}))
        traffic = _merge(traffic, traffic.get("rehearsal", {}))

    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < int(cell["chips"])):
        print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "(--device cpu rehearses it at a tiny size)", file=sys.stderr)
        return 2
    import memex_tpu_torch  # noqa: F401 -- fails outside a checkout of the repository

    tmp = tempfile.mkdtemp(prefix="perfbench_", dir=os.environ.get("TMPDIR"))
    ctx = Ctx(cell=cell, config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=args.device, tmp=tmp,
              t_start=T_START)
    try:
        out = driver(traffic["kind"]).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = forbidden_modules() + list(out.get("child_forbidden") or [])
    if bad:
        print(f"perfbench: forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 3
    correct, checks = judge(out["readings"], traffic["limits"])
    device = dict(out["device"])
    if args.device == "cuda":
        device["power_limit_w"] = power_limit_w()
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": compose(bench, cell, out, bool(args.trace), args.device),
            "device": device}
    tr = out.get("trace")
    if args.trace and tr is not None:
        device["busy_s"] = tr["busy_s"] if args.device == "cuda" else "not measured"
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    log(f"notes: {json.dumps(out.get('notes', {}), default=str)}")
    if tr is not None:
        for name, (n, secs) in sorted(tr["kernels"].items(), key=lambda x: -x[1][1])[:40]:
            log(f"kernel {secs:.6f} s {n:6d}x {name[:200]}")
    log(f"setup_s {out['setup_s']:.3f}, window {out['window_s']:.3f} s, "
        f"attempted {line['attempted']}, failed {line['failed']}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
