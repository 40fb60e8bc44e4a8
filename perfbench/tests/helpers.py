"""Shared by the benchmark's own tests: run a cell at its rehearsal size
on the CPU in a subprocess and read its result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rehearse(workload: str, *, trace: int = 0, seed: int = 2**31 + 11, seconds: float = 2.0,
             cwd: str = ROOT, pythonpath: list[str] | None = None,
             timeout: float = 900) -> tuple[int, dict | None, str]:
    """(exit code, the last stdout line as JSON or None, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join((pythonpath or []) + [cwd, ROOT])
    env["MEMEX_NO_NATIVE"] = "1"
    env.setdefault("OMP_NUM_THREADS", "2")
    proc = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace), "--device", "cpu"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return proc.returncode, line, proc.stderr
