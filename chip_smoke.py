#!/usr/bin/env python3
"""Smoke run of the PyTorch port (memex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout and drives
the ingest-and-search path, failing (non-zero exit, no result line) on any
failed phase:

  0. a CUDA card is present; its name and power limit are printed;
  1. the fused score+top-k kernel (K1, csrc/fused_topk.cu) against its
     plain PyTorch version at the flat index's shapes (1,048,576 x 384 rows,
     f32 and bf16, Q in {1, 32, 128}, the three exact/keep2 modes the float
     tiers use), with both times;
  2. the HTTP server (`python -m memex_tpu_torch serve`) at full
     all-MiniLM-L12-v2 width with seeded random weights: ~200 documents
     ingested, searches from 32 concurrent clients, proof through the
     server's launch counter that the searches ran the kernel;
  3. a 1,048,576-row float32 index: retrieval checks against a float32
     brute-force oracle, then the fused text-query path timed at Q in
     {1, 32, 128}.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1 << 20
DIM = 384
# Kernel vs plain version: both sum 384 products of inputs in [-1, 1] in
# float32, in different orders; the difference is a few float32 ulps of
# a score <= 1 (~1e-6 observed), so 2e-5 is loose for the arithmetic and
# tight against any real indexing or masking fault.
SCORE_TOL = 2e-5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` timings of fn() by CUDA events, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def unit_rows(n: int, d: int, gen, device):
    import torch

    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


# -- phase 1 -------------------------------------------------------------------

def compare_topk(kv, ki, pv, pi, db, q, exact: bool) -> tuple[float, int]:
    """Kernel (kv, ki) vs plain (pv, pi) top lists of one call. Values must
    agree within SCORE_TOL position by position; an index may differ only
    where the two lists hold near-equal values, and then the kernel's row
    must really score what the kernel says. Returns (max abs error,
    number of differing positions)."""
    import torch

    from memex_tpu_torch.ops.fused_topk import scores_f32

    err = (kv - pv).abs().max().item()
    check(err <= SCORE_TOL, f"values differ by {err:.3e} > {SCORE_TOL}")
    diff = ki != pi
    n_diff = int(diff.sum().item())
    if n_diff:
        qi, pos = torch.nonzero(diff, as_tuple=True)
        rows = ki[qi, pos].long()
        true = scores_f32(q[qi][:, None, :], db[rows][:, :, None].float(), exact)[:, 0, 0]
        gap = (true - kv[qi, pos]).abs().max().item()
        check(gap <= SCORE_TOL, f"kernel index scores {gap:.3e} off its value")
    return err, n_diff


def phase1(label: str, seed: int) -> dict:
    import torch

    from memex_tpu_torch import kernels
    from memex_tpu_torch.ops import fused_topk as ft

    t0 = time.perf_counter()
    path = kernels.build()
    print(f"[{label}] phase1 kernel build {time.perf_counter() - t0:.1f}s -> "
          f"{os.path.relpath(path, ROOT)}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    db32 = unit_rows(N_ROWS, DIM, gen, dev)
    alive = (torch.rand(N_ROWS, generator=gen, device=dev) > 0.01).float()
    count = N_ROWS - 12345
    worst, main_ms, main_plain = 0.0, None, None
    for dtype in (torch.float32, torch.bfloat16):
        db = db32.to(dtype)
        for exact, keep2 in ((False, False), (False, True), (True, True)):
            for Q in (1, 32, 128):
                q = unit_rows(Q, DIM, gen, dev)
                kw = dict(count=count, alive=alive, exact=exact, keep2=keep2)
                kv, ki = ft.fused_score_topk(db, q, 128, **kw)
                pv, pi = ft.fused_score_topk_reference(db, q, 128, **kw)
                torch.cuda.synchronize()
                err, n_diff = compare_topk(kv, ki, pv, pi, db, q,
                                           exact and dtype == torch.float32)
                worst = max(worst, err)
                ms = cuda_ms(lambda: ft.fused_score_topk(db, q, 128, **kw))
                bank_ms = cuda_ms(lambda: ft.fused_score_bank_cuda(db, q, **kw))
                plain_ms = cuda_ms(lambda: ft.fused_score_topk_reference(db, q, 128, **kw))
                name = "f32" if dtype == torch.float32 else "bf16"
                print(f"[{label}] phase1 K1 rows={name} exact={exact} keep2={keep2} Q={Q} "
                      f"max_abs_err={err:.3e} idx_diff={n_diff} kernel_ms={ms:.4f} "
                      f"(bank only {bank_ms:.4f}) plain_ms={plain_ms:.4f}", flush=True)
                if dtype == torch.float32 and not exact and not keep2 and Q == 32:
                    main_ms, main_plain = ms, plain_ms
        del db
    del db32, alive
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain}


# -- phase 2 -------------------------------------------------------------------

def make_docs(rng: random.Random, n: int) -> list[str]:
    """Short lowercase documents (one 256-token window each under the
    character-level fallback vocab), distinct by construction."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = ["".join(rng.choice(letters) for _ in range(rng.randint(3, 7)))
             for _ in range(3000)]
    return [" ".join([f"doc{i}"] + [rng.choice(words) for _ in range(rng.randint(12, 30))])
            for i in range(n)]


def http(method: str, url: str, body: dict | None = None, timeout: float = 120.0) -> dict:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_checkpoint(model_dir: str, seed: int) -> None:
    """Seeded random all-MiniLM-L12-v2-width checkpoint in HF format."""
    from memex_tpu.text.tokenizer import _build_fallback_vocab
    from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, save_params

    cfg = MiniLMConfig()  # 12 layers, 384 hidden, 12 heads, 1536 FFN, 512 pos, 30522 vocab
    save_params(model_dir, cfg, MiniLM(cfg).init_random(seed), vocab=_build_fallback_vocab())


def phase2(label: str, seed: int, work: str) -> int:
    model_dir = os.path.join(work, "model")
    write_checkpoint(model_dir, seed)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, EMBEDDING_MODEL=model_dir,
               DATABASE_CONNECTION=f"sqlite://{work}/memex.db",
               VECTOR_CONNECTION=f"tpu://{work}/vectors", HOST="127.0.0.1",
               PORT=str(port), MEMEX_FAKE_LLM="1",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(work, "server.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "memex_tpu_torch", "serve", "--roles", "Api,Worker",
             "--device", "cuda"], cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        return _drive_server(label, seed, base, proc)
    except BaseException:
        with open(log_path) as fh:
            sys.stderr.write("server log tail:\n" + fh.read()[-4000:] + "\n")
        raise
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _launches(base: str) -> int:
    return http("GET", f"{base}/api/stats")["counters"].get("kernels.fused_topk.launches", 0)


def _drive_server(label: str, seed: int, base: str, proc) -> int:
    deadline = time.monotonic() + 300
    while True:
        check(proc.poll() is None, f"server exited with {proc.returncode}")
        try:
            http("GET", f"{base}/api/health", timeout=5)
            break
        except OSError:
            check(time.monotonic() < deadline, "server did not come up in 300s")
            time.sleep(0.5)
    rng = random.Random(seed)
    docs = make_docs(rng, 200)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(16) as pool:
        tasks = list(pool.map(lambda d: http("POST", f"{base}/api/collections/smoke",
                                             {"content": d})["result"]["taskId"], docs))
    pending = set(tasks)
    while pending:
        check(time.perf_counter() - t0 < 600, f"{len(pending)} ingest tasks unfinished")
        for tid in list(pending):
            status = http("GET", f"{base}/api/tasks/{tid}")["result"]["status"]
            check(status != "Failed", f"ingest task {tid} failed")
            if status == "Completed":
                pending.discard(tid)
        time.sleep(0.05)
    ingest_s = time.perf_counter() - t0
    print(f"[{label}] phase2 ingest docs={len(docs)} seconds={ingest_s:.3f} "
          f"docs_per_s={len(docs) / ingest_s:.2f}", flush=True)

    before = _launches(base)
    limit, per_client, clients = 10, 4, 32
    picks = [rng.randrange(len(docs)) for _ in range(per_client * clients)]

    def client(c: int) -> list[tuple[float, int, dict]]:
        out = []
        for j in range(per_client):
            i = picks[c * per_client + j]
            t = time.perf_counter()
            body = http("POST", f"{base}/api/collections/smoke/search",
                        {"query": docs[i], "limit": limit})
            out.append((time.perf_counter() - t, i, body))
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        runs = [r for rs in pool.map(client, range(clients)) for r in rs]
    wall = time.perf_counter() - t0
    after = _launches(base)
    lat = sorted(r[0] * 1e3 for r in runs)
    for _, i, body in runs:
        hits = body["result"]["results"]
        check(len(hits) == limit, f"search returned {len(hits)} hits, expected {limit}")
        check(hits[0]["content"] == docs[i],
              f"exact-text query for doc {i} ranked {hits[0]['content'][:40]!r} first")
    launches = after - before
    check(launches > 0, "the HTTP searches launched the fused_topk kernel 0 times")
    print(f"[{label}] phase2 search requests={len(runs)} clients={clients} "
          f"qps={len(runs) / wall:.2f} p50_ms={lat[len(lat) // 2]:.3f} "
          f"p99_ms={lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.3f} "
          f"kernel_launches={launches} (server count before searches: {before})", flush=True)
    return launches


# -- phase 3 -------------------------------------------------------------------

def phase3(label: str, seed: int, work: str) -> int:
    import numpy as np
    import torch

    from memex_tpu_torch.embed import EmbeddingEngine
    from memex_tpu_torch.index.flat import FlatIndex
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.serve.query_path import FusedQueryPath
    from memex_tpu_torch.store.flat_store import TpuFlatStore

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    base = unit_rows(N_ROWS, DIM, gen, dev)
    t0 = time.perf_counter()
    store = TpuFlatStore(None, "scale", dim=DIM, device=dev)
    index: FlatIndex = store.index
    index.add(base.cpu().numpy(), [f"r{i}" for i in range(N_ROWS)])
    torch.cuda.synchronize()
    print(f"[{label}] phase3 bulk load rows={N_ROWS} seconds={time.perf_counter() - t0:.3f} "
          f"buffer_gb={index.buf.numel() * 4 / 1e9:.3f}", flush=True)

    src = torch.randperm(N_ROWS, generator=gen, device=dev)[:128]
    q = base[src] + 0.05 / DIM ** 0.5 * torch.randn((128, DIM), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    ft.LAUNCHES = 0
    hits = index.search(q.cpu().numpy(), 10)
    check(ft.LAUNCHES > 0, "FlatIndex.search did not launch the fused_topk kernel")
    oracle = torch.sort(q @ base.T, dim=1, descending=True, stable=True).indices[:, :10].cpu()
    src = src.cpu().numpy()
    top1 = np.mean([h[0][0] == f"r{s}" for h, s in zip(hits, src)])
    recall = np.mean([len({x for x, _ in h} & {f"r{int(j)}" for j in o}) / 10
                      for h, o in zip(hits, oracle)])
    print(f"[{label}] phase3 FlatIndex.search Q=128 source_row_first={top1:.4f} "
          f"recall_at_10_vs_f32_oracle={recall:.4f}", flush=True)
    check(top1 >= 0.99, f"source row first for only {top1:.4f} of queries")
    check(recall >= 0.95, f"recall@10 {recall:.4f} < 0.95")
    del base

    engine = EmbeddingEngine(os.path.join(work, "model"), device=dev)
    fqp = FusedQueryPath(engine)
    texts = make_docs(random.Random(seed + 5), 128)
    launches = 0
    for Q in (1, 32, 128):
        fqp.search_texts(store, texts[:Q], 10)  # first use of this shape
        ft.LAUNCHES = 0
        times = []
        for _ in range(20):
            t = time.perf_counter()
            res = fqp.search_texts(store, texts[:Q], 10)  # ends in the copy back
            times.append((time.perf_counter() - t) * 1e3)
        launches += ft.LAUNCHES
        check(ft.LAUNCHES == 20, f"fused query path launched K1 {ft.LAUNCHES}x in 20 batches")
        check(len(res) == Q and all(len(h) == 10 for h in res), "short fused-path results")
        print(f"[{label}] phase3 FusedQueryPath texts Q={Q} rows={N_ROWS} "
              f"median_ms={statistics.median(times):.3f} min_ms={min(times):.3f}", flush=True)
    return launches


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    try:
        label = card_label()
        print(label, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        k1 = phase1(label, args.seed)
        work = tempfile.mkdtemp(prefix="memex_smoke_")
        try:
            http_launches = phase2(label, args.seed, work)
            phase3(label, args.seed, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    except (SmokeFailure, ImportError, RuntimeError, OSError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "fused_topk",
        "route": "cuda",
        "source": "memex_tpu_torch/csrc/fused_topk.cu",
        "replaces": "memex_tpu/ops/fused_topk.py:80",
        "launches": http_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
