#!/usr/bin/env python3
"""Smoke run of the PyTorch port (memex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and drives
the ingest-and-search path of every flat tier, failing (non-zero exit, no
result line) on any failed phase:

  0. a CUDA card is present; its name and power limit are printed;
  1. each scan kernel against its plain PyTorch version at the flat
     index's shapes (1,048,576 x 384 rows, count = N - 12345, ~1% dead
     rows, Q in {1, 32, 128}), with kernel, bank-only and plain times:
     K1 (csrc/fused_topk.cu) on f32 and bf16 rows in the three exact/keep2
     modes the float tiers use; K2 (int8 rows, int8 queries, S = 512,
     keep2 off/on) and K4 in shift mode (int4 rows, S = 1024 and 2048,
     keep2 off/on), both bit-equal to their plain versions; K3 (int8 rows,
     bf16 queries, S = 1024) and K4 in deferred mode, within tolerance;
  2. the HTTP server (`python -m memex_tpu_torch serve`) at full
     all-MiniLM-L12-v2 width with seeded random weights, on a float32
     store and on an int8+refine store (~200 documents each), then on a
     `tpu+ivf://` store (~1,200 documents, enough for the store's spill
     rule to enqueue a worker Maintain task, which trains the index):
     searches from 32 concurrent clients, proof through the server's
     launch counters that the searches ran K1, K2, then K5;
  3. 1,048,576-row indexes of each flat tier, one at a time (float32,
     int8, int8 with bf16 queries, int8+refine, int4, int4+refine):
     retrieval checks against a float32 brute-force oracle, proof that each
     search launched its tier's kernel, and the fused text-query path
     timed at Q in {1, 32, 128} on the float32, int8 and int4 stores;
  4. the IVF tier at memex_tpu's 10M configuration (bench.py: 10,485,760
     clustered rows, int8, n_clusters=4096, nprobe=64, bucket_factor=1.2,
     built on the device): K5 (keep2 off/on), K6 (its int4 mirror) and K7
     against their plain versions on the index's routed unions at Q in
     {1, 32, 128}; recall@10 of IVFIndex.search against a float32 oracle
     for int8 (K5) and scan_int4 (K6); the store's search_batch timed on
     text queries; then 1,048,576-row host-built indexes (float32,
     float32 with scan_precision="highest", int8+refine) and a 4-cluster
     index whose buckets only K7 can scan, each with a recall check; on
     the float32 ones K5 in the mode each search runs (bf16-rounded rows,
     as the HTTP run's float32 store; exact with keep2), and on the
     4-cluster one K7 on its own probes, against their plain versions.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts (from the main-path run of each:
HTTP for K1, K2 and K5, IVFIndex.search for K6 and K7, the 1M-row
searches for K3 and K4), errors and times.
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
# Float kernels (K1, K3, K4's rerank) vs plain version: both sum 384
# products in float32, in different orders; the difference is a few
# float32 ulps of a score <= 1 (~1e-6 observed), so 2e-5 is loose for the
# arithmetic and tight against any real indexing or masking fault.
SCORE_TOL = 2e-5
# The kernels' TPU originals (memex_tpu/ops/).
REPLACES = {
    "fused_topk": "memex_tpu/ops/fused_topk.py:80",
    "fused_topk_int8q": "memex_tpu/ops/fused_topk.py:412",
    "fused_topk_int8": "memex_tpu/ops/fused_topk.py:274",
    "fused_topk_int4q": "memex_tpu/ops/fused_topk.py:578",
    "ivf_batch": "memex_tpu/ops/ivf_batch.py:108",
    "ivf_batch4": "memex_tpu/ops/ivf_batch4.py:103",
    "ivf_probe": "memex_tpu/ops/ivf_scan.py:31",
}
SOURCES = {
    "fused_topk": "memex_tpu_torch/csrc/fused_topk.cu",
    "fused_topk_int8q": "memex_tpu_torch/csrc/fused_topk_int8.cu",
    "fused_topk_int8": "memex_tpu_torch/csrc/fused_topk_int8.cu",
    "fused_topk_int4q": "memex_tpu_torch/csrc/fused_topk_int4.cu",
    "ivf_batch": "memex_tpu_torch/csrc/ivf_batch.cu",
    "ivf_batch4": "memex_tpu_torch/csrc/ivf_batch4.cu",
    "ivf_probe": "memex_tpu_torch/csrc/ivf_scan.cu",
}


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


def plain_ms(fn) -> float:
    """The plain versions take 40-200 ms a call: 5 runs after 1 warmup."""
    return cuda_ms(fn, runs=5, warmup=1)


def unit_rows(n: int, d: int, gen, device):
    import torch

    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


# -- phase 1 -------------------------------------------------------------------

def compare_topk(kv, ki, pv, pi, score_of) -> tuple[float, int]:
    """Kernel (kv, ki) vs plain (pv, pi) top lists of one call. Values must
    agree within SCORE_TOL position by position; an index may differ only
    where the two lists hold near-equal values, and then the kernel's row
    must really score what the kernel says: score_of(query_idx, rows).
    Returns (max abs error, number of differing positions)."""
    import torch

    err = (kv - pv).abs().max().item()
    check(err <= SCORE_TOL, f"values differ by {err:.3e} > {SCORE_TOL}")
    diff = ki != pi
    n_diff = int(diff.sum().item())
    if n_diff:
        qi, pos = torch.nonzero(diff, as_tuple=True)
        gap = (score_of(qi, ki[qi, pos].long()) - kv[qi, pos]).abs().max().item()
        check(gap <= SCORE_TOL, f"kernel index scores {gap:.3e} off its value")
    return err, n_diff


def bit_equal(a: list, b: list, what: str) -> None:
    import torch

    for x, y in zip(a, b, strict=True):
        check(torch.equal(x, y), f"{what}: kernel and plain version differ")


def gbps(n_bytes: int, ms: float) -> str:
    return f"{n_bytes / (ms * 1e-3) / 1e9:.1f}"


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
    out = {}
    worst, main_ms, main_plain = 0.0, None, None
    for dtype in (torch.float32, torch.bfloat16):
        db = db32.to(dtype)
        for exact, keep2 in ((False, False), (False, True), (True, True)):
            full = exact and dtype == torch.float32
            for Q in (1, 32, 128):
                q = unit_rows(Q, DIM, gen, dev)
                kw = dict(count=count, alive=alive, exact=exact, keep2=keep2)
                kv, ki = ft.fused_score_topk(db, q, 128, **kw)
                pv, pi = ft.fused_score_topk_reference(db, q, 128, **kw)
                torch.cuda.synchronize()
                err, n_diff = compare_topk(kv, ki, pv, pi, lambda qi, rows: ft.scores_f32(
                    q[qi][:, None, :], db[rows][:, :, None].float(), full)[:, 0, 0])
                worst = max(worst, err)
                ms = cuda_ms(lambda: ft.fused_score_topk(db, q, 128, **kw))
                bank_ms = cuda_ms(lambda: ft.fused_score_bank_cuda(db, q, **kw))
                p_ms = plain_ms(lambda: ft.fused_score_topk_reference(db, q, 128, **kw))
                name = "f32" if dtype == torch.float32 else "bf16"
                print(f"[{label}] phase1 K1 rows={name} exact={exact} keep2={keep2} Q={Q} "
                      f"max_abs_err={err:.3e} idx_diff={n_diff} kernel_ms={ms:.4f} "
                      f"(bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} row_read_GBps="
                      f"{gbps(count * (db.element_size() * DIM + 4), bank_ms)}", flush=True)
                if dtype == torch.float32 and not exact and not keep2 and Q == 32:
                    main_ms, main_plain = ms, p_ms
        del db
    out["fused_topk"] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain}

    # int8 codes of the same rows; int4 codes packed row-major as the
    # index stores them (byte j = 16 * code[j + D/2] + code[j]).
    codes, scales = ft.quantize_rows_int8(db32)
    s4 = torch.clamp(db32.abs().amax(dim=1), min=1e-12) / 7.0
    c4 = torch.clamp(torch.round(db32 / s4[:, None]), -7, 7).to(torch.int32)
    packed = (c4[:, : DIM // 2] + 16 * c4[:, DIM // 2 :]).to(torch.int8).contiguous()
    del db32, s4, c4
    torch.cuda.empty_cache()
    row8, row4 = count * (DIM + 8), count * (DIM // 2 + 8)  # codes + scale + alive

    # K2: bit-equal to its plain version, bank and top list.
    res = {}
    for keep2 in (False, True):
        for Q in (1, 32, 128):
            q = unit_rows(Q, DIM, gen, dev)
            q8, _ = ft.quantize_rows_int8(q)
            kw = dict(count=count, alive=alive, banks=4, keep2=keep2)
            bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw)
            plain = ft.int8q_bank_reference(codes, scales, q8, **kw)
            bit_equal(bank[0] + bank[1], plain[0] + plain[1], f"K2 bank keep2={keep2} Q={Q}")
            kv, ki = ft.fused_score_topk_int8q(codes, scales, q, 128, **kw)
            pv, pi = ft.fused_score_topk_int8q_reference(codes, scales, q, 128, **kw)
            bit_equal([kv, ki], [pv, pi], f"K2 top list keep2={keep2} Q={Q}")
            ms = cuda_ms(lambda: ft.fused_score_topk_int8q(codes, scales, q, 128, **kw))
            bank_ms = cuda_ms(lambda: ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw))
            p_ms = plain_ms(lambda: ft.fused_score_topk_int8q_reference(codes, scales, q, 128,
                                                                       **kw))
            print(f"[{label}] phase1 K2 int8q S=512 keep2={keep2} Q={Q} bit_equal=True "
                  f"kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} "
                  f"row_read_GBps={gbps(row8, bank_ms)}", flush=True)
            res[(keep2, Q)] = (ms, p_ms)
    out["fused_topk_int8q"] = {"max_abs_err": 0.0, "ms": res[(False, 32)][0],
                               "plain_ms": res[(False, 32)][1]}

    # K3: K1's tolerance.
    worst, res = 0.0, {}
    for Q in (1, 32, 128):
        q = unit_rows(Q, DIM, gen, dev)
        kw = dict(count=count, alive=alive, banks=8)
        kv, ki = ft.fused_score_topk_int8(codes, scales, q, 128, **kw)
        pv, pi = ft.fused_score_topk_int8_reference(codes, scales, q, 128, **kw)
        err, n_diff = compare_topk(kv, ki, pv, pi, lambda qi, rows: (
            q[qi].bfloat16().float() * codes[rows].float()).sum(1) * scales[rows])
        worst = max(worst, err)
        ms = cuda_ms(lambda: ft.fused_score_topk_int8(codes, scales, q, 128, **kw))
        bank_ms = cuda_ms(lambda: ft.fused_score_bank_int8_cuda(codes, scales, q, **kw))
        p_ms = plain_ms(lambda: ft.fused_score_topk_int8_reference(codes, scales, q, 128, **kw))
        print(f"[{label}] phase1 K3 int8 S=1024 Q={Q} max_abs_err={err:.3e} idx_diff={n_diff} "
              f"kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} "
              f"row_read_GBps={gbps(row8, bank_ms)}", flush=True)
        res[Q] = (ms, p_ms)
    out["fused_topk_int8"] = {"max_abs_err": worst, "ms": res[32][0], "plain_ms": res[32][1]}

    # K4: shift bit-equal; deferred (bf16 query operands) by compare_topk's
    # rule on the reranked list, its bank's equality reported.
    worst, res = 0.0, {}
    for banks in (8, 16):
        for deferred in (False, True):
            for keep2 in (False, True):
                for Q in (1, 32, 128):
                    q = unit_rows(Q, DIM, gen, dev)
                    kw = dict(count=count, alive=alive, banks=banks, deferred=deferred,
                              keep2=keep2)
                    bank = ft.int4q_candidates_cuda(packed, scales, q, **kw)
                    plain = ft.int4q_candidates_reference(packed, scales, q, **kw)
                    same = all(torch.equal(a, b) for a, b in zip(bank, plain))
                    if not deferred:
                        check(same, f"K4 shift bank S={banks * 128} keep2={keep2} Q={Q}: "
                                    "kernel and plain version differ")
                    args = (packed, scales, codes, q, 10)
                    kv, ki = ft.fused_score_topk_int4_rerank(*args, **kw)
                    pv, pi = ft.fused_score_topk_int4_rerank_reference(*args, **kw)
                    err, n_diff = compare_topk(kv, ki, pv, pi, lambda qi, rows: (
                        q[qi].bfloat16().float() * codes[rows].float()).sum(1) * scales[rows])
                    worst = max(worst, err)
                    ms = cuda_ms(lambda: ft.fused_score_topk_int4_rerank(*args, **kw))
                    bank_ms = cuda_ms(lambda: ft.int4q_candidates_cuda(packed, scales, q, **kw))
                    p_ms = plain_ms(lambda: ft.fused_score_topk_int4_rerank_reference(*args,
                                                                                      **kw))
                    mode = "deferred" if deferred else "shift"
                    print(f"[{label}] phase1 K4 int4 {mode} S={banks * 128} keep2={keep2} "
                          f"Q={Q} bank_bit_equal={same} max_abs_err={err:.3e} "
                          f"idx_diff={n_diff} kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) "
                          f"plain_ms={p_ms:.4f} row_read_GBps={gbps(row4, bank_ms)}",
                          flush=True)
                    res[(banks, deferred, keep2, Q)] = (ms, p_ms)
    main = res[(8, True, False, 32)]
    out["fused_topk_int4q"] = {"max_abs_err": worst, "ms": main[0], "plain_ms": main[1]}
    del codes, scales, packed, alive
    torch.cuda.empty_cache()
    return out


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


def phase2(label: str, seed: int, work: str, store: str, kernel: str, scheme: str = "tpu",
           n_docs: int = 200) -> int:
    """One server run on VECTOR_CONNECTION={scheme}://{work}/{store} with
    n_docs documents; returns the launches of `kernel` its searches made.
    An IVF store's searches wait for the Maintain tasks its ingest queued."""
    model_dir = os.path.join(work, "model")
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    name = store.split("?")[0]
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    db_path = os.path.join(work, f"{name}.db")
    env = dict(os.environ, EMBEDDING_MODEL=model_dir,
               DATABASE_CONNECTION=f"sqlite://{db_path}",
               VECTOR_CONNECTION=f"{scheme}://{work}/{store}", HOST="127.0.0.1",
               PORT=str(port), MEMEX_FAKE_LLM="1",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(work, f"server_{name}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "memex_tpu_torch", "serve", "--roles", "Api,Worker",
             "--device", "cuda"], cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        return _drive_server(f"{label}] [{scheme}://{store}", seed, base, proc, kernel, n_docs,
                             db_path if scheme == "tpu+ivf" else None)
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


def _launches(base: str, kernel: str) -> int:
    return http("GET", f"{base}/api/stats")["counters"].get(f"kernels.{kernel}.launches", 0)


def wait_maintenance(label: str, db_path: str, timeout: float = 300.0) -> None:
    """Wait until the server's queue holds Maintain tasks and all are
    Completed (the worker retrained the index)."""
    import sqlite3

    t0 = time.perf_counter()
    while True:
        with sqlite3.connect(db_path) as conn:
            states = [r[0] for r in conn.execute(
                "SELECT status FROM queue WHERE task_type = 'Maintain'")]
        check("Failed" not in states, "a Maintain task failed")
        if states and all(st == "Completed" for st in states):
            break
        check(time.perf_counter() - t0 < timeout,
              f"Maintain tasks {states or 'never queued'} after {timeout:.0f}s")
        time.sleep(0.2)
    print(f"[{label}] phase2 maintain tasks={len(states)} completed "
          f"wait_seconds={time.perf_counter() - t0:.3f}", flush=True)


def _drive_server(label: str, seed: int, base: str, proc, kernel: str, n_docs: int,
                  maintain_db: str | None) -> int:
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
    docs = make_docs(rng, n_docs)
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
    if maintain_db:
        wait_maintenance(label, maintain_db)

    before = _launches(base, kernel)
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
    after = _launches(base, kernel)
    lat = sorted(r[0] * 1e3 for r in runs)
    for _, i, body in runs:
        hits = body["result"]["results"]
        check(len(hits) == limit, f"search returned {len(hits)} hits, expected {limit}")
        check(hits[0]["content"] == docs[i],
              f"exact-text query for doc {i} ranked {hits[0]['content'][:40]!r} first")
    launches = after - before
    check(launches > 0, f"the HTTP searches launched the {kernel} kernel 0 times")
    print(f"[{label}] phase2 search requests={len(runs)} clients={clients} "
          f"qps={len(runs) / wall:.2f} p50_ms={lat[len(lat) // 2]:.3f} "
          f"p99_ms={lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.3f} "
          f"kernel_launches={launches} (server count before searches: {before})", flush=True)
    return launches


# -- phase 3 -------------------------------------------------------------------

# (name, FlatIndex options, the kernel its search runs, recall@10 bar).
# Smoke bars for random unit rows: refine tiers rerank at ~14-bit fidelity.
TIERS = (
    ("float32", {}, "fused_topk", 0.95),
    ("int8", {"dtype": "int8"}, "fused_topk_int8q", 0.95),
    ("int8-bf16-queries", {"dtype": "int8", "query_quantize": False}, "fused_topk_int8", 0.95),
    ("int8-refine", {"dtype": "int8", "refine": True}, "fused_topk_int8q", 0.99),
    ("int4", {"dtype": "int4"}, "fused_topk_int4q", 0.95),
    ("int4-refine", {"dtype": "int4", "refine": True}, "fused_topk_int4q", 0.99),
)
TIMED_TIERS = ("float32", "int8", "int4")


def phase3(label: str, seed: int, work: str) -> dict:
    """Each tier's 1M-row index in turn (freed before the next). Returns
    the launches each kernel made in its tiers' searches."""
    import numpy as np
    import torch

    from memex_tpu_torch.embed import EmbeddingEngine
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.serve.query_path import FusedQueryPath
    from memex_tpu_torch.store.flat_store import TpuFlatStore

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    base = unit_rows(N_ROWS, DIM, gen, dev)
    src = torch.randperm(N_ROWS, generator=gen, device=dev)[:128]
    q = base[src] + 0.05 / DIM ** 0.5 * torch.randn((128, DIM), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    oracle = torch.sort(q @ base.T, dim=1, descending=True, stable=True).indices[:, :10].cpu()
    base_np, q_np, src = base.cpu().numpy(), q.cpu().numpy(), src.cpu().numpy()
    ids = [f"r{i}" for i in range(N_ROWS)]
    del base
    torch.cuda.empty_cache()

    engine = EmbeddingEngine(os.path.join(work, "model"), device=dev)
    fqp = FusedQueryPath(engine)
    texts = make_docs(random.Random(seed + 5), 128)
    launches = dict.fromkeys(ft.LAUNCHES, 0)
    for name, opts, kernel, bar in TIERS:
        t0 = time.perf_counter()
        store = TpuFlatStore(None, f"scale-{name}", dim=DIM, device=dev, **opts)
        index = store.index
        index.add(base_np, ids)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in (
            index.buf, index.buf8, index.scales, index.rbuf, index.rbuf_scales)
            if t is not None)
        print(f"[{label}] phase3 {name} bulk load rows={N_ROWS} "
              f"seconds={time.perf_counter() - t0:.3f} device_gb={n_bytes / 1e9:.3f}", flush=True)
        ft.reset_launches()
        hits = index.search(q_np, 10)
        n = ft.LAUNCHES[kernel]
        check(n > 0, f"{name}: FlatIndex.search did not launch {kernel}")
        launches[kernel] += n
        top1 = np.mean([h[0][0] == f"r{s}" for h, s in zip(hits, src)])
        recall = np.mean([len({x for x, _ in h} & {f"r{int(j)}" for j in o}) / 10
                          for h, o in zip(hits, oracle)])
        print(f"[{label}] phase3 {name} FlatIndex.search Q=128 {kernel}_launches={n} "
              f"source_row_first={top1:.4f} recall_at_10_vs_f32_oracle={recall:.4f} "
              f"(bar {bar})", flush=True)
        check(top1 >= 0.99, f"{name}: source row first for only {top1:.4f} of queries")
        check(recall >= bar, f"{name}: recall@10 {recall:.4f} < {bar}")
        if name in TIMED_TIERS:
            launches[kernel] += time_query_path(label, name, fqp, store, texts, kernel)
        del store, index
        torch.cuda.empty_cache()
    return launches


def time_query_path(label: str, name: str, fqp, store, texts: list[str], kernel: str) -> int:
    """FusedQueryPath.search_texts at Q in {1, 32, 128}, median of 20
    batches; each batch must launch the tier's kernel once. Records int4's
    unpack mode (memex_tpu's rule: deferred up to a 64-query bucket)."""
    import torch

    from memex_tpu_torch.ops import fused_topk as ft

    modes: list[bool] = []
    candidates = ft.int4q_candidates

    def recording(*args, **kw):
        modes.append(kw["deferred"])
        return candidates(*args, **kw)

    launches = 0
    ft.int4q_candidates = recording
    try:
        for Q in (1, 32, 128):
            fqp.search_texts(store, texts[:Q], 10)  # first use of this shape
            torch.cuda.synchronize()
            modes.clear()
            ft.reset_launches()
            times = []
            for _ in range(20):
                t = time.perf_counter()
                res = fqp.search_texts(store, texts[:Q], 10)  # ends in the copy back
                times.append((time.perf_counter() - t) * 1e3)
            launches += ft.LAUNCHES[kernel]
            check(ft.LAUNCHES[kernel] == 20,
                  f"{name}: fused query path launched {kernel} {ft.LAUNCHES[kernel]}x in 20 batches")
            check(len(res) == Q and all(len(h) == 10 for h in res), "short fused-path results")
            mode = ""
            if modes:
                check(set(modes) == {Q <= 64}, f"int4 unpack modes {set(modes)} at Q={Q}")
                mode = f" int4_mode={'deferred' if modes[0] else 'shift'}"
            print(f"[{label}] phase3 {name} FusedQueryPath texts Q={Q} rows={N_ROWS}{mode} "
                  f"median_ms={statistics.median(times):.3f} min_ms={min(times):.3f}",
                  flush=True)
    finally:
        ft.int4q_candidates = candidates
    return launches


# -- phase 4 -------------------------------------------------------------------

# memex_tpu's 10M IVF configuration (bench.py:588-590) and its corpus: rows
# scattered around 8,192 unit centres with sigma = 0.75 / sqrt(D)
# (bench.py:466-481; cos(row, centre) ~ 0.8).
N_10M = 10 * (1 << 20)
IVF_10M = dict(n_clusters=4096, nprobe=64, dtype="int8", bucket_factor=1.2)
IVF_CENTRES = 8192
IVF_K = 10
IVF_1M_CLUSTERS = 1024
# (name, host-built 1M IVFIndex options, kernel, recall@10 bar).
IVF_1M = (
    ("float32", {}, "ivf_batch", 0.93),
    ("float32-highest", {"scan_precision": "highest"}, "ivf_batch", 0.93),
    ("int8-refine", {"dtype": "int8", "refine": True}, "ivf_batch", 0.95),
)


def clustered_rows(n: int, centres, gen, block: int = 1 << 20):
    """[n, D] float32 unit rows around random centres, made on the card."""
    import torch

    sigma = 0.75 / DIM ** 0.5
    out = torch.empty((n, DIM), device=centres.device)
    for lo in range(0, n, block):
        m = min(block, n - lo)
        asg = torch.randint(0, centres.shape[0], (m,), generator=gen, device=centres.device)
        v = centres[asg] + sigma * torch.randn((m, DIM), generator=gen, device=centres.device)
        out[lo : lo + m] = v / v.norm(dim=1, keepdim=True)
    return out


def oracle_topk(q, corpus, k: int = IVF_K, block: int = 1 << 20):
    """Exact float32 top-k ids of q against the corpus, blockwise."""
    import torch

    best_v = best_i = None
    for lo in range(0, corpus.shape[0], block):
        sc = q @ corpus[lo : lo + block].T
        v, i = torch.topk(sc, k, dim=1)
        i = i + lo
        if best_v is not None:
            v, j = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_v, best_i = v, i
    return best_i.cpu().numpy()


def recall_at_k(hits, oracle) -> float:
    import numpy as np

    return float(np.mean([len({int(s) for s, _ in h} & {int(j) for j in o}) / len(o)
                          for h, o in zip(hits, oracle)]))


def index_gb(index) -> float:
    parts = [index.data, index.rscales, index.resid, index.resid_scales, index._data4,
             index._rscales4, index._rowids_dev, index.spill.buf, index.spill.scales,
             index.spill.rbuf, index.spill.rbuf_scales, index.spill.alive]
    return sum(t.numel() * t.element_size() for t in parts if t is not None) / 1e9


def compare_bank(bank, plain, score_of) -> tuple[float, int]:
    """Kernel bank vs plain bank, slot by slot: values within SCORE_TOL; an
    index may differ only where the kernel's row scores what the kernel
    holds. Returns (max abs error, differing slots)."""
    import torch

    err, n_diff = 0.0, 0
    for kv, ki, pv, pi in zip(bank[0], bank[1], plain[0], plain[1], strict=True):
        err = max(err, (kv - pv).abs().max().item())
        live = kv > -1e29
        check(torch.equal(live, pv > -1e29), "kernel and plain banks fill different slots")
        diff = live & (ki != pi)
        n_diff += int(diff.sum().item())
        if diff.any():
            qi, slot = torch.nonzero(diff, as_tuple=True)
            gap = (score_of(qi, ki[qi, slot].long()) - kv[qi, slot]).abs().max().item()
            check(gap <= SCORE_TOL, f"kernel index scores {gap:.3e} off its value")
    check(err <= SCORE_TOL, f"bank values differ by {err:.3e} > {SCORE_TOL}")
    return err, n_diff


def phase4(label: str, seed: int, work: str) -> tuple[dict, dict]:
    """The IVF tier on the card. Returns (launches of K6 and K7 in
    IVFIndex.search, kernel stats of K5-K7)."""
    import numpy as np
    import torch

    from memex_tpu_torch.embed import EmbeddingEngine
    from memex_tpu_torch.index.ivf import IVFIndex, _route
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops import ivf_batch as ib
    from memex_tpu_torch.ops import ivf_batch4 as ib4
    from memex_tpu_torch.ops import ivf_scan as isc
    from memex_tpu_torch.store.ivf_store import TpuIVFStore

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    centres = unit_rows(IVF_CENTRES, DIM, gen, dev)
    t0 = time.perf_counter()
    corpus = clustered_rows(N_10M, centres, gen)
    queries = clustered_rows(128, centres, gen)
    oracle = oracle_topk(queries, corpus)
    codes = torch.empty((N_10M, DIM), dtype=torch.int8, device=dev)
    scales = torch.empty((N_10M,), device=dev)
    for lo in range(0, N_10M, 1 << 20):
        codes[lo : lo + (1 << 20)], scales[lo : lo + (1 << 20)] = ft.quantize_rows_int8(
            corpus[lo : lo + (1 << 20)])
    del corpus
    torch.cuda.empty_cache()
    print(f"[{label}] phase4 10M corpus rows={N_10M} + oracle "
          f"seconds={time.perf_counter() - t0:.3f}", flush=True)

    store = TpuIVFStore(None, "ivf10m", dim=DIM, device=dev, **IVF_10M)
    index = store.index
    t0 = time.perf_counter()
    index.build_device(codes, scales, list(range(N_10M)))
    torch.cuda.synchronize()
    del codes, scales
    torch.cuda.empty_cache()
    C, M, _ = index.data.shape
    data4, rsc4 = index._int4_mirror()
    print(f"[{label}] phase4 10M build_device seconds={time.perf_counter() - t0:.3f} C={C} "
          f"M={M} spill_rows={index.spill.count} device_gb={index_gb(index):.3f}", flush=True)

    flat, fsc = index.data.view(-1, DIM), index.rscales.view(-1)
    hi4 = None
    stats, res = {}, {}
    for Q in (1, 32, 128):
        q = queries[:Q].contiguous()
        clist, nact = ib.route_union(index.centroids, q, index.nprobe)
        walk, n_chunks = ib._chunk_walk(index.sizes, clist, nact, M, 1024)
        n_ch = int(n_chunks[0])
        q16 = q.bfloat16().float()

        def score8(qi, idx):
            return (q16[qi] * flat[idx].float()).sum(1) * fsc[idx]

        for keep2 in (False, True):
            args = (index.data, index.rscales, index.sizes, walk, n_chunks, q)
            bank = ib.ivf_batch_bank_cuda(*args, banks=8, keep2=keep2)
            plain = ib.ivf_batch_bank_reference(*args, banks=8, keep2=keep2)
            torch.cuda.synchronize()
            err, n_diff = compare_bank(bank, plain, score8)
            top_args = (index.data, index.rscales, index.sizes, clist, nact, q, IVF_K)
            ms = cuda_ms(lambda: ib.ivf_batch_topk(*top_args, banks=8, keep2=keep2))
            bank_ms = cuda_ms(lambda: ib.ivf_batch_bank_cuda(*args, banks=8, keep2=keep2))
            p_ms = plain_ms(lambda: ft._bank_topk(
                *ib.ivf_batch_bank_reference(*args, banks=8, keep2=keep2), IVF_K))
            n_bytes = n_ch * 1024 * (DIM + 4)
            print(f"[{label}] phase4 K5 int8 S=1024 keep2={keep2} Q={Q} union_clusters="
                  f"{int(nact[0])} chunks={n_ch} bytes={n_bytes} max_abs_err={err:.3e} "
                  f"slot_idx_diff={n_diff} kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) "
                  f"plain_ms={p_ms:.4f} row_read_GBps={gbps(n_bytes, bank_ms)}", flush=True)
            res[("ivf_batch", keep2, Q)] = (err, ms, p_ms)

        if hi4 is None:
            hi4 = torch.clamp((flat.to(torch.int32) + 8) >> 4, -7, 7).to(torch.int8)
        rs4 = rsc4.view(-1)

        def score4(qi, idx):
            return (q16[qi] * hi4[idx].float()).sum(1) * rs4[idx]

        args4 = (data4, rsc4, index.sizes, walk, n_chunks, q)
        bank = ib4.ivf_batch4_bank_cuda(*args4, banks=8)
        plain = ib4.ivf_batch4_bank_reference(*args4, banks=8)
        torch.cuda.synchronize()
        err, n_diff = compare_bank(bank, plain, score4)
        ms = cuda_ms(lambda: ib4.ivf_batch_topk4(data4, rsc4, index.sizes, clist, nact, q,
                                                  1024, banks=8))
        bank_ms = cuda_ms(lambda: ib4.ivf_batch4_bank_cuda(*args4, banks=8))
        p_ms = plain_ms(lambda: ft._bank_topk(*ib4.ivf_batch4_bank_reference(*args4, banks=8),
                                              1024))
        n_bytes = n_ch * 1024 * (DIM // 2 + 4)
        print(f"[{label}] phase4 K6 int4 S=1024 Q={Q} chunks={n_ch} bytes={n_bytes} "
              f"max_abs_err={err:.3e} slot_idx_diff={n_diff} kernel_ms={ms:.4f} (bank only "
              f"{bank_ms:.4f}) plain_ms={p_ms:.4f} row_read_GBps={gbps(n_bytes, bank_ms)}",
              flush=True)
        res[("ivf_batch4", False, Q)] = (err, ms, p_ms)

        probes = _route(index.centroids, q, index.nprobe).to(torch.int32)
        argsp = (index.data, index.rscales, index.sizes, probes, q)
        bank = isc.ivf_probe_bank_cuda(*argsp)
        plain = isc.ivf_probe_bank_reference(*argsp)
        torch.cuda.synchronize()
        err, n_diff = compare_bank(bank, plain, score8)
        ms = cuda_ms(lambda: isc.ivf_probe_topk(*argsp[:4], q, IVF_K))
        bank_ms = cuda_ms(lambda: isc.ivf_probe_bank_cuda(*argsp))
        p_ms = plain_ms(lambda: ft._bank_topk(*isc.ivf_probe_bank_reference(*argsp), IVF_K))
        live = int(index.sizes.long()[probes.long()].sum())
        n_bytes = live * (DIM + 4)
        print(f"[{label}] phase4 K7 int8 S=256 Q={Q} probed_rows={live} bytes={n_bytes} "
              f"max_abs_err={err:.3e} slot_idx_diff={n_diff} kernel_ms={ms:.4f} (bank only "
              f"{bank_ms:.4f}) plain_ms={p_ms:.4f} row_read_GBps={gbps(n_bytes, bank_ms)}",
              flush=True)
        res[("ivf_probe", False, Q)] = (err, ms, p_ms)
    del hi4
    for name in ("ivf_batch", "ivf_batch4", "ivf_probe"):
        mine = [v for key, v in res.items() if key[0] == name]
        main = res[(name, False, 32)]
        stats[name] = {"max_abs_err": max(v[0] for v in mine), "ms": main[1],
                       "plain_ms": main[2]}

    # Recall through IVFIndex.search, each search proven to run its kernel.
    q_np = queries.cpu().numpy()
    launches = {}
    for scan_int4, kernel in ((False, "ivf_batch"), (True, "ivf_batch4")):
        index.scan_int4 = scan_int4
        ft.reset_launches()
        hits = index.search(q_np, IVF_K)
        n = ft.LAUNCHES[kernel]
        check(n > 0, f"10M IVFIndex.search (scan_int4={scan_int4}) did not launch {kernel}")
        if scan_int4:
            launches[kernel] = n  # K5's main path is the HTTP run
        rec = recall_at_k(hits, oracle)
        print(f"[{label}] phase4 10M int8 scan_int4={scan_int4} IVFIndex.search Q=128 "
              f"{kernel}_launches={n} recall_at_10_vs_f32_oracle={rec:.4f} (bar 0.93)",
              flush=True)
        check(rec >= 0.93, f"10M IVF scan_int4={scan_int4}: recall@10 {rec:.4f} < 0.93")
    index.scan_int4 = False

    engine = EmbeddingEngine(os.path.join(work, "model"), device=dev)
    texts = make_docs(random.Random(seed + 7), 128)
    for Q in (1, 32, 128):
        vecs = engine.encode_batch(texts[:Q])
        store.search_batch(vecs, IVF_K)  # first use of this shape
        torch.cuda.synchronize()
        ft.reset_launches()
        times = []
        for _ in range(20):
            t = time.perf_counter()
            out = store.search_batch(engine.encode_batch(texts[:Q]), IVF_K)
            times.append((time.perf_counter() - t) * 1e3)
        check(ft.LAUNCHES["ivf_batch"] == 20 and len(out) == Q,
              f"10M store.search_batch launched K5 {ft.LAUNCHES['ivf_batch']}x in 20 batches")
        print(f"[{label}] phase4 10M TpuIVFStore.search_batch(encode_batch(texts)) Q={Q} "
              f"median_ms={statistics.median(times):.3f} min_ms={min(times):.3f}", flush=True)
    del store, index, data4, rsc4, flat, fsc, rs4
    torch.cuda.empty_cache()

    # Host-built 1M indexes, and one whose buckets only K7 can scan.
    base = clustered_rows(N_ROWS, centres, gen)
    q1 = clustered_rows(128, centres, gen)
    oracle1 = oracle_topk(q1, base)
    base_np, q1_np = base.cpu().numpy(), q1.cpu().numpy()
    del base
    torch.cuda.empty_cache()
    ids = list(range(N_ROWS))
    for name, opts, kernel, bar, kw, n_q in (
            *((n, o, k, b, dict(n_clusters=IVF_1M_CLUSTERS), 128) for n, o, k, b in IVF_1M),
            ("int8-4-clusters", {"dtype": "int8"}, "ivf_probe", 0.90, dict(n_clusters=4), 32)):
        t0 = time.perf_counter()
        index = IVFIndex(DIM, nprobe=64, bucket_factor=1.2, device=dev, **kw, **opts)
        index.build(base_np, ids)
        torch.cuda.synchronize()
        M = index.data.shape[1]
        print(f"[{label}] phase4 1M {name} host build seconds={time.perf_counter() - t0:.3f} "
              f"C={index.C} M={M} chunks_of_1024={M // 1024} spill_rows={index.spill.count} "
              f"device_gb={index_gb(index):.3f}", flush=True)
        ft.reset_launches()
        t0 = time.perf_counter()
        hits = index.search(q1_np[:n_q], IVF_K)
        search_s = time.perf_counter() - t0
        n = ft.LAUNCHES[kernel]
        check(n > 0, f"1M IVF {name}: IVFIndex.search did not launch {kernel}")
        if kernel == "ivf_probe":
            launches[kernel] = n
        rec = recall_at_k(hits, oracle1[:n_q])
        print(f"[{label}] phase4 1M {name} IVFIndex.search Q={n_q} {kernel}_launches={n} "
              f"seconds={search_s:.3f} recall_at_10_vs_f32_oracle={rec:.4f} (bar {bar})",
              flush=True)
        check(rec >= bar, f"1M IVF {name}: recall@10 {rec:.4f} < {bar}")
        if kernel == "ivf_probe":
            err = compare_probe_scan(label, name, index, q1[:n_q])
        elif index.dtype == "float32":
            err = compare_float_scan(label, name, index, q1)
        else:
            err = 0.0  # K5 keep2 on int8 rows: held at 10M above
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        del index
        torch.cuda.empty_cache()
    return launches, stats


def compare_float_scan(label: str, name: str, index, q) -> float:
    """K5 on a float32 1M index's routed union, in the mode its search runs
    (bf16-rounded inputs; exact with keep2 under scan_precision="highest"),
    against the plain version. Returns the max abs error."""
    import torch

    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops import ivf_batch as ib

    exact = keep2 = index.scan_precision == "highest"
    M = index.data.shape[1]
    flat = index.data.view(-1, DIM)
    banks = index._batch_banks()
    clist, nact = ib.route_union(index.centroids, q, index.nprobe)
    walk, n_chunks = ib._chunk_walk(index.sizes, clist, nact, M, banks * 128)
    args = (index.data, index.rscales, index.sizes, walk, n_chunks, q)
    kw = dict(banks=banks, exact=exact, keep2=keep2)
    bank = ib.ivf_batch_bank_cuda(*args, **kw)
    plain = ib.ivf_batch_bank_reference(*args, **kw)
    torch.cuda.synchronize()
    err, n_diff = compare_bank(bank, plain, lambda qi, idx: ft.scores_f32(
        q[qi][:, None, :], flat[idx][:, :, None], exact)[:, 0, 0])
    bank_ms = cuda_ms(lambda: ib.ivf_batch_bank_cuda(*args, **kw))
    p_ms = plain_ms(lambda: ib.ivf_batch_bank_reference(*args, **kw))
    n_ch = int(n_chunks[0])
    n_bytes = n_ch * banks * 128 * DIM * 4
    print(f"[{label}] phase4 1M {name} K5 f32 S={banks * 128} exact={exact} keep2={keep2} "
          f"Q={q.shape[0]} "
          f"union_clusters={int(nact[0])} chunks={n_ch} max_abs_err={err:.3e} "
          f"slot_idx_diff={n_diff} bank_ms={bank_ms:.4f} plain_bank_ms={p_ms:.4f} "
          f"row_read_GBps={gbps(n_bytes, bank_ms)}", flush=True)
    return err


def compare_probe_scan(label: str, name: str, index, q, block: int = 8) -> float:
    """K7 on the index's own probes against the plain version, which runs
    `block` queries at a time (a query's plain bank holds its probes' whole
    buckets in float32). Returns the max abs error."""
    import torch

    from memex_tpu_torch.index.ivf import _route
    from memex_tpu_torch.ops import ivf_scan as isc

    flat, fsc = index.data.view(-1, DIM), index.rscales.view(-1)
    probes = _route(index.centroids, q, index.nprobe).to(torch.int32)
    args = (index.data, index.rscales, index.sizes, probes, q)
    bank = isc.ivf_probe_bank_cuda(*args)
    parts = [isc.ivf_probe_bank_reference(index.data, index.rscales, index.sizes,
                                          probes[lo : lo + block], q[lo : lo + block])
             for lo in range(0, q.shape[0], block)]
    plain = tuple([torch.cat([p[j][0] for p in parts])] for j in (0, 1))
    torch.cuda.synchronize()
    q16 = q.bfloat16().float()
    err, n_diff = compare_bank(bank, plain, lambda qi, idx: (
        q16[qi] * flat[idx].float()).sum(1) * fsc[idx])
    bank_ms = cuda_ms(lambda: isc.ivf_probe_bank_cuda(*args))
    live = int(index.sizes.long()[probes.long()].sum())
    print(f"[{label}] phase4 1M {name} K7 int8 S=256 Q={q.shape[0]} nprobe={probes.shape[1]} "
          f"M={index.data.shape[1]} probed_rows={live} max_abs_err={err:.3e} "
          f"slot_idx_diff={n_diff} bank_ms={bank_ms:.4f} "
          f"row_read_GBps={gbps(live * (DIM + 4), bank_ms)}", flush=True)
    return err


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
        stats = phase1(label, args.seed)
        work = tempfile.mkdtemp(prefix="memex_smoke_")
        try:
            # Each kernel's launches come from its tier's main-path run:
            # HTTP searches for K1 (float32), K2 (int8+refine) and K5 (IVF),
            # the 1M-row searches for K3 and K4, IVFIndex.search for K6, K7.
            http = {"fused_topk": phase2(label, args.seed, work, "vectors", "fused_topk"),
                    "fused_topk_int8q": phase2(label, args.seed, work,
                                               "vectors_q?dtype=int8&refine=true",
                                               "fused_topk_int8q"),
                    "ivf_batch": phase2(label, args.seed, work,
                                        "vectors_ivf?n_clusters=16&nprobe=4", "ivf_batch",
                                        scheme="tpu+ivf", n_docs=1200)}
            launches = phase3(label, args.seed, work)
            ivf_launches, ivf_stats = phase4(label, args.seed, work)
            stats.update(ivf_stats)
            launches.update(ivf_launches)
            launches.update(http)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        for name, n in launches.items():
            check(n > 0, f"the main path launched {name} 0 times")
    except (SmokeFailure, ImportError, RuntimeError, OSError) as exc:
        print(f"FAIL: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **stats[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
