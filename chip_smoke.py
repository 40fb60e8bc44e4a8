#!/usr/bin/env python3
"""Smoke run of the PyTorch port (memex_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and drives
the ingest-and-search path of every flat tier, the IVF tier and the
sharded tiers (on one controller and on two ranks of a process group), the
local LLM, encoder fine-tuning and the encoder's bulk and data-parallel
ingest, the recall/QPS harness, the benchmark entry point with its
real-text stages, the flat-tier sweeps and the clippy client, failing
(non-zero exit, no result line) on any failed phase:

  0. a CUDA card is present; its name and power limit are printed;
  1. each scan kernel against its plain PyTorch version at the flat
     index's shapes (1,048,576 x 384 rows, count = N - 12345, ~1% dead
     rows, Q in {1, 32, 128}), with kernel, bank-only and plain times:
     K1 (csrc/fused_topk.cu) on f32 and bf16 rows in the three exact/keep2
     modes the float tiers use; K2 (int8 rows, int8 queries, S = 512 and
     1024, keep2 off/on) and K4 in shift and in deferred mode (int4 rows,
     S = 1024 and 2048, keep2 off/on), bit-equal to their plain versions,
     also at Q in {2, 31, 33, 64}, around the widths of their tensor-core
     tiles; K3 (int8 rows, bf16 queries, S = 1024) within tolerance, bank
     and top list, at the same batch sizes;
  2. the HTTP server (`python -m memex_tpu_torch serve`) at full
     all-MiniLM-L12-v2 width with seeded random weights, on a float32
     store and on an int8+refine store (100 documents each), then on a
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
     built on the device): K5 (keep2 off/on) and K7 (each query's own
     probes: a shape off K7's path, as IVFIndex.search sends these buckets
     to K5) against their plain versions at Q in {1, 32, 128}, K6 (its
     int4 mirror, S = 512 and 1024, keep2 off/on) at Q in {1, 2, 31, 32, 33,
     64, 128}; recall@10 of IVFIndex.search against a float32 oracle
     for int8 (K5) and scan_int4 (K6); the store's search_batch timed on
     text queries; then 1,048,576-row host-built indexes (float32,
     float32 with scan_precision="highest", int8+refine) and a 4-cluster
     index whose buckets only K7 can scan (built twice from one seed: its
     k-means must give bit-equal centroids), each with a recall check; on
     the float32 ones K5 in the mode each search runs (bf16-rounded rows,
     as the HTTP run's float32 store; exact with keep2), and on the
     4-cluster one K7 on its own probes at Q = 1 and 32, against their
     plain versions (K7's line in the kernels list is this index's).
  5. the sharded tiers, four shards on the one card: ShardedFlatIndex on
     phase 3's rows in the float32 (K1), int8 (K2), int8-bf16-queries
     (K3) and int4 (K4) tiers, and ShardedIVFIndex at the 10M
     configuration (K5), built with build_device from phase 4's device
     codes: each search launches its kernel once a shard; every hit's
     score is its row's under the tier's arithmetic; recall@10 against the
     float32 oracles and the top-10 overlap with phase 3's unsharded
     FlatIndex at their bars; shard 0's bank against its plain version at
     Q = 32; search times at Q = 1 / 32 / 128 beside the unsharded
     indexes' (FlatIndex.search in phase 3, IVFIndex.search in phase 4);
     then the HTTP server on a `tpu+mesh://` int8 store, its searches
     running K2 (`/api/stats`);
  6. the local LLM (memex_tpu_torch/llm/local/) at full width with seeded
     random weights drawn on the card: TinyLlama-1.1B geometry in bf16,
     Llama-2-7B in bf16 and int8, GPT-J-6B in bf16, the two 7B-class
     models cut to 4 layers (LLM_7B_LAYERS). For each: its first
     two layers at full width in float32 on the card against the CPU; the
     bf16 logits against the float32 model's, int8's against the float32
     model of its stored weights after a check of every code (cosine); 8
     cached decode steps against one prefill (cosine); greedy streaming
     against greedy generate (the same tokens); llm_bench.py's
     prefill_ms, batch_tok_per_s, stream_tok_per_s and first_token_ms at
     P = 128 and 128 new tokens, each beside its bound (weight and KV
     bytes a step at 3.35 TB/s), and the device-busy share of one
     16-token decode_chunk (torch.profiler, after every timing); a chunk
     run under CUDA's sync-debug mode must not read the card back. Then
     the HTTP server with LOCAL_LLM_CONFIG on a TinyLlama-1.1B-geometry
     HF checkpoint (float16 safetensors, bf16 on the card): two
     concurrent /api/action/ask (random weights: mostly the route's 400
     "LLM response was not valid JSON") and a Summarize task that must
     reach Completed. No scan kernel runs in this phase.
  7. encoder fine-tuning (memex_tpu_torch/train/) at all-MiniLM-L12-v2
     width on phase 2's checkpoint: `python -m memex_tpu_torch load
     traincol <dir> --wait` of 96 generated documents (~1,400 adjacent-
     window pairs), `train traincol --out ft --checkpoint st.npz` and
     again with `--resume st.npz` (its step must double); in process, on
     one batch of 32 pairs of 64 tokens: a two-layer copy's step on the
     card against the CPU (loss, Adam's first moment, params), two runs
     of two steps from one seed bit-equal, the step over [cuda:0,
     cuda:0] against one entry, the loss falling over 10 steps on one
     batch; the step's ms, pairs/s and busy share beside its bound (its
     float32 operations at 67 TFLOP/s, TF32 off) and its costliest
     kernels; then the HTTP server on the exported encoder (`ft`, a
     float32 `tpu://` store, 50 documents, 8 clients), whose searches
     must launch K1.
  8. multi-host bring-up: two ranks spawned here, joined over gloo
     (MEMEX_DIST_BACKEND=gloo; NCCL refuses two ranks on one card), each a
     controller of one shard on the card: ShardedFlatIndex over the
     process group on phase 3's shape of rows (1,048,576 x 384, made on
     the card from the seed alike on both ranks) in the float32 (K1), int8
     (K2), int8-bf16-queries (K3) and int4 (K4) tiers, and ShardedIVFIndex
     at phase 4's 1M-row configuration in int8 (K5): one launch of the
     tier's kernel a rank a search, each rank's bank against its plain
     version, recall@10 at phase 3's and phase 4's bars, hits identical on
     both ranks and to the single controller over two shards of the card;
     search times at Q = 1 / 32 / 128 beside the single controller's and
     the all_gather's; then `serve` on two ranks at full MiniLM-L12 width
     (`tpu+mesh://`, 50 documents posted to both in lockstep, 16 searches
     sent to both at once): identical hits, one K1 launch a rank a search,
     a clean shutdown with each rank's own copy of the same checkpoint. A
     rank that fails or runs past its time fails the phase.
  9. the encoder's ingest paths and the last scoring entry points: 16,384
     generated windows at all-MiniLM-L12-v2 width (phase 2's checkpoint,
     bf16 compute, L = 256, max_batch = 512) through `_encode_padded`,
     which must take the bulk path, once for each fetch dtype (float32,
     float16, bfloat16): windows/s and the bulk path's dispatch_s /
     device_sync_s / fetch_s beside the bound (the encoder's matmul
     operations at 989 TFLOP/s bf16), the float32 pass's busy share
     (torch.profiler) and its difference from the chunked path; the
     float16 and bfloat16 outputs must be the float32 output rounded, bit
     for bit; then the data-parallel encode over [cuda:0, cuda:0] (and
     every card, where there are several) against one device on 1,000
     windows. On 1,048,576 x 384 float32 rows drawn on the card:
     FlatIndex.search at Q = 1 / 32 / 128 through ops.host.fetch, hits
     equal to those of .cpu() copies, ms beside phase 3's; score_topk at
     Q = 128 (exact_f32 equal to the float32 oracle; blockwise, exact and
     approx bit-equal to each other, recall@10 >= 0.99), each method's
     ms; the int8q rerank on the rows' int8 codes (phase 1's count and
     ~1% dead rows) at Q = 1 / 32 / 128: one K2 launch a call, its bank
     bit-equal to the plain version's, the top-10 equal to the plain
     version's, no dead row among the hits, recall@10 at Q = 128 at or
     above K2's own top list, ms beside it.
 10. the recall/QPS harness (memex_tpu_torch/benchmarks/) through its entry
     points at all-MiniLM-L12-v2 width: `run.main` on memex_tpu's
     clustered corpus (1,048,576 x 384, 32 queries, k = 10) in the flat,
     flat_bf16, flat_int8 and ivf_int8 tiers on the card (recall@10 >=
     0.95 flat, >= 0.93 IVF; K1, K2 and K5, or K7, launched); the blocked
     device oracle (`datasets._oracle_topk_device`, 262,144-row blocks)
     against the numpy one on that corpus (recall >= 0.999, every mismatch
     a float64 near-tie within 1e-5); run.main's hnsw tier at 8,192 rows
     (a one-core build); hnsw_recall at memex_tpu's test configuration
     (8,192 x 384 around 2,048 centres, 64 queries, seed 4242): the
     native HNSW at the reference's M = 16, ef_construction = 200,
     ef_search = 32, every device tier (float32, bfloat16, int8 with bf16
     queries, int8q, int4, ivf_int8) at or above its recall, and a second
     build_or_load a cache hit with the same ids; then `llm_bench.main` at
     TinyLlama-1.1B geometry, printed beside phase 6's readings.
 11. the benchmark entry point (memex_tpu_torch/bench.py, memex_tpu's
     bench.py on the card) through `bench.main(["--device", "cuda"])`
     with MEMEX_BENCH_10M_BLOCKS=1 (scale_10M at 1,048,576 rows) and
     llm_decode skipped (phases 6 and 10 drive llm_bench): its last line
     parses, no stage errs and none is skipped for the budget, every
     kernels tier holds its recall bar (0.95; 0.99 the refine tiers),
     scale_10M's IVF int8 and int4 0.93 and refine 0.95 against its
     true-float32 oracle, whose regenerated block 0 must equal its first
     draw bit for bit, the sharded IVF 0.93 and its refine variant 0.95;
     its compact line and each stage's seconds are printed, and its
     K1-K6 launches join the kernels line.
 12. the last programs that ran memex_tpu, ported: bench.main's
     ivf_prune_realtext and sotu_e2e must be {"skipped": "reference
     corpus not present"} (no upstream document beside the checkout), as
     memex_tpu's; then `bench_realtext_ivf(path=SURVEY.md)` at 16,384
     windows and full MiniLM-L12 width (the bulk ingest path's roofline,
     each IVF tier's calibrated operating point, tie-aware recall@10 >=
     0.95 for float32 and int8_refine, union clusters; K5 launched) and
     `bench_sotu(path=SURVEY.md)` (windows, ingest_s, query p50, int8 vs
     float32 recall@10 >= 0.9; K2 launched), with the weights probe
     refused (no connection is opened); the four flat sweeps
     (memex_tpu_torch/benchmarks/: keep2_validate, int4_refine_sweep,
     int4_bank_sweep, int4_bank_sweep2) at 1,048,576 x 384 through
     main(), their rows' keys and recall@10 >= 0.95 (K2 and K4
     launched), and every K2/K4 combination they launch held bit-equal
     to its plain version at their arguments (K4 at S = 4096 is new);
     then `memex_tpu_torch.clippy` against a port server on an int8
     store: load-file SURVEY.md, ask with --local-llm on phase 6's
     TinyLlama-geometry checkpoint (bf16, text streamed as ids decode;
     first-token, first-piece and total ms, ids against pieces), forget; the ask's search launched K2.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts (summed over the main-path runs of
each: HTTP for K1, K2 and K5, IVFIndex.search for K6 and K7, the 1M-row
searches for K3 and K4, phase 5's sharded path for K1-K5, phase 7's
server on the fine-tuned encoder for K1, phase 8's two ranks for K1-K5,
phase 9's searches for K1 and its int8q reranks for K2, phase 10's
harness searches for K1-K5, phase 11's bench stages for K1-K6, and
phase 12's real-text stages for K5 and K2, its sweeps for K2 and K4 and
clippy's search for K2),
errors (phase 5's and phase 8's shard banks included) and times at Q =
32: the kernel's, its plain version's, its bound (the larger of the bytes
it must move at 3.35 TB/s and its operations at the card's peak for their
type, live rows only) and one PyTorch call computing the same product on
operands laid out beforehand (library_ms: torch.matmul, or torch._int_mm
for int8 queries; the port never calls it).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_Q = 32  # the batch each kernel's line reports
TIMED_Q = (1, 32, 128)
# K2, K3, K4 and K6 are also checked around their tile widths: 16 queries a
# pair of n-tiles, 32 a fold pass, more on further warps.
TILE_Q = (1, 2, 31, 32, 33, 64, 128)
BENCH_BIG_Q = (256, 512)  # K2's batches in bench's int8q_q256 / _q512 tiers
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
    """The plain versions take 40-1,500 ms a call: 3 runs after 1 warmup."""
    return cuda_ms(fn, runs=3, warmup=1)


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


def columns(bound: tuple[float, str], library: float | None) -> dict:
    """The kernels line's bound (from memex_tpu_torch/scan_bench.py's bound
    functions, which its own records use) and library columns."""
    return {"bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}


def phase1(label: str, seed: int) -> dict:
    import torch

    from memex_tpu_torch import kernels
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.scan_bench import (int_mm_ms, k1_bound, k2_bound, k3_bound, k4_bound,
                                            pack_int4)

    t0 = time.perf_counter()
    path = kernels.build()
    print(f"[{label}] phase1 kernel build {time.perf_counter() - t0:.1f}s -> "
          f"{os.path.relpath(path, ROOT)}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    db32 = unit_rows(N_ROWS, DIM, gen, dev)
    alive = (torch.rand(N_ROWS, generator=gen, device=dev) > 0.01).float()
    count = N_ROWS - 12345
    live = int((alive[:count] > 0).sum())
    out = {}
    worst, main_ms, main_plain, main_cols = 0.0, None, None, None
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
                if dtype == torch.float32 and not exact and not keep2 and Q == MAIN_Q:
                    main_ms, main_plain = ms, p_ms
                    rows16, q16 = db[:count].bfloat16(), q.bfloat16()
                    lib = cuda_ms(lambda: torch.matmul(q16, rows16.T))
                    del rows16
                    main_cols = columns(k1_bound(Q, live, count, DIM * 4, 1024), lib)
                    print(f"[{label}] phase1 K1 rows=f32 Q={Q} bound_ms="
                          f"{main_cols['bound_ms']:.4f} ({main_cols['bound_by']}) "
                          f"library_ms={lib:.4f} (torch.matmul, bf16 operands)", flush=True)
        del db
    out["fused_topk"] = {"max_abs_err": worst, "ms": main_ms, "plain_ms": main_plain,
                         **main_cols}

    # int8 codes of the same rows; int4 codes packed row-major as the
    # index stores them (byte j = 16 * code[j + D/2] + code[j]), and the
    # int4 codes themselves for K4's library_ms.
    codes, scales = ft.quantize_rows_int8(db32)
    packed, c4 = pack_int4(db32)
    del db32
    torch.cuda.empty_cache()
    row8, row4 = count * (DIM + 8), count * (DIM // 2 + 8)  # codes + scale + alive

    # K2: bit-equal to its plain version, bank and top list, at the batch
    # sizes around the tensor-core body's tile widths and both bank widths;
    # timed at S = 512, the flat index's.
    res = {}
    for banks in (4, 8):
        for keep2 in (False, True):
            for Q in TILE_Q:
                q = unit_rows(Q, DIM, gen, dev)
                q8, _ = ft.quantize_rows_int8(q)
                kw = dict(count=count, alive=alive, banks=banks, keep2=keep2)
                what = f"S={banks * 128} keep2={keep2} Q={Q}"
                bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw)
                plain = ft.int8q_bank_reference(codes, scales, q8, **kw)
                bit_equal(bank[0] + bank[1], plain[0] + plain[1], f"K2 bank {what}")
                kv, ki = ft.fused_score_topk_int8q(codes, scales, q, 128, **kw)
                pv, pi = ft.fused_score_topk_int8q_reference(codes, scales, q, 128, **kw)
                bit_equal([kv, ki], [pv, pi], f"K2 top list {what}")
                if banks != 4 or Q not in TIMED_Q:
                    print(f"[{label}] phase1 K2 int8q {what} bit_equal=True", flush=True)
                    continue
                ms = cuda_ms(lambda: ft.fused_score_topk_int8q(codes, scales, q, 128, **kw))
                bank_ms = cuda_ms(lambda: ft.fused_score_bank_int8q_cuda(codes, scales, q8,
                                                                         **kw))
                p_ms = plain_ms(lambda: ft.fused_score_topk_int8q_reference(codes, scales, q,
                                                                           128, **kw))
                print(f"[{label}] phase1 K2 int8q {what} bit_equal=True "
                      f"kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} "
                      f"row_read_GBps={gbps(row8, bank_ms)}", flush=True)
                res[(keep2, Q)] = (ms, p_ms)
                if not keep2 and Q == MAIN_Q:
                    # All N rows (N % 8 == 0, as _int_mm asks); K2 scans `count`.
                    k2_cols = columns(k2_bound(Q, live, count, 512),
                                      int_mm_ms(q8, codes.t(), "K2"))
    out["fused_topk_int8q"] = {"max_abs_err": 0.0, "ms": res[(False, MAIN_Q)][0],
                               "plain_ms": res[(False, MAIN_Q)][1], **k2_cols}
    # ... and at the batches of bench's int8q_q256 / _q512 tiers (phase 11),
    # two and four 128-query tiles, with their arguments: every row, no
    # mask, S = 512, the top 10.
    for Q in BENCH_BIG_Q:
        q = unit_rows(Q, DIM, gen, dev)
        q8, _ = ft.quantize_rows_int8(q)
        kw = dict(count=N_ROWS, banks=4)
        bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw)
        plain = ft.int8q_bank_reference(codes, scales, q8, **kw)
        bit_equal(bank[0] + bank[1], plain[0] + plain[1], f"K2 bank S=512 Q={Q}")
        top = ft.fused_score_topk_int8q(codes, scales, q, 10, **kw)
        bit_equal(list(top), list(ft.fused_score_topk_int8q_reference(codes, scales, q, 10,
                                                                      **kw)),
                  f"K2 top list S=512 Q={Q}")
        print(f"[{label}] phase1 K2 int8q S=512 Q={Q} count={N_ROWS} k=10 bit_equal=True",
              flush=True)
        del bank, plain, top

    # K3: K1's tolerance (the tensor cores sum the 384 products in another
    # order than the plain version's matmul), bank and top list, at the
    # batch sizes around the body's tile widths.
    worst, res = 0.0, {}
    for Q in TILE_Q:
        q = unit_rows(Q, DIM, gen, dev)
        kw = dict(count=count, alive=alive, banks=8)

        def score3(qi, rows):
            return (q[qi].bfloat16().float() * codes[rows].float()).sum(1) * scales[rows]

        bank = ft.fused_score_bank_int8_cuda(codes, scales, q, **kw)
        plain = ft.int8_bank_reference(codes, scales, q, **kw)
        torch.cuda.synchronize()
        err, slot_diff = compare_bank(bank, plain, score3)
        kv, ki = ft.fused_score_topk_int8(codes, scales, q, 128, **kw)
        pv, pi = ft.fused_score_topk_int8_reference(codes, scales, q, 128, **kw)
        err2, n_diff = compare_topk(kv, ki, pv, pi, score3)
        worst = max(worst, err, err2)
        what = (f"S=1024 Q={Q} max_abs_err={max(err, err2):.3e} slot_idx_diff={slot_diff} "
                f"idx_diff={n_diff}")
        if Q not in TIMED_Q:
            print(f"[{label}] phase1 K3 int8 {what}", flush=True)
            continue
        ms = cuda_ms(lambda: ft.fused_score_topk_int8(codes, scales, q, 128, **kw))
        bank_ms = cuda_ms(lambda: ft.fused_score_bank_int8_cuda(codes, scales, q, **kw))
        p_ms = plain_ms(lambda: ft.fused_score_topk_int8_reference(codes, scales, q, 128, **kw))
        print(f"[{label}] phase1 K3 int8 {what} "
              f"kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} "
              f"row_read_GBps={gbps(row8, bank_ms)}", flush=True)
        res[Q] = (ms, p_ms)
        if Q == MAIN_Q:
            codes16, q16 = codes[:count].bfloat16(), q.bfloat16()
            k3_cols = columns(k3_bound(Q, live, count, 1024),
                              cuda_ms(lambda: torch.matmul(q16, codes16.T)))
            del codes16
    out["fused_topk_int8"] = {"max_abs_err": worst, "ms": res[MAIN_Q][0],
                              "plain_ms": res[MAIN_Q][1], **k3_cols}

    # K4: the bank bit-equal in both modes (each is an exact integer dot),
    # at the same batch sizes and both bank widths; the reranked list by
    # compare_topk's rule (its rerank sums float32 products).
    worst, res = 0.0, {}
    for banks in (8, 16):
        for deferred in (False, True):
            mode = "deferred" if deferred else "shift"
            for keep2 in (False, True):
                for Q in TILE_Q:
                    q = unit_rows(Q, DIM, gen, dev)
                    kw = dict(count=count, alive=alive, banks=banks, deferred=deferred,
                              keep2=keep2)
                    what = f"{mode} S={banks * 128} keep2={keep2} Q={Q}"
                    bank = ft.int4q_candidates_cuda(packed, scales, q, **kw)
                    plain = ft.int4q_candidates_reference(packed, scales, q, **kw)
                    bit_equal(bank, plain, f"K4 bank {what}")
                    # ... and so are the wrapper's query operands, which one
                    # launch of the source's query-operand kernel makes.
                    bit_equal(ft.int4_query_operands_cuda(q, deferred),
                              ft._int4_query_operands(q, deferred), f"K4 query operands {what}")
                    if Q not in TIMED_Q:
                        print(f"[{label}] phase1 K4 int4 {what} bank_bit_equal=True",
                              flush=True)
                        continue
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
                    print(f"[{label}] phase1 K4 int4 {what} bank_bit_equal=True "
                          f"max_abs_err={err:.3e} "
                          f"idx_diff={n_diff} kernel_ms={ms:.4f} (bank only {bank_ms:.4f}) "
                          f"plain_ms={p_ms:.4f} row_read_GBps={gbps(row4, bank_ms)}",
                          flush=True)
                    res[(banks, deferred, keep2, Q)] = (ms, p_ms)
                    if banks == 8 and deferred and not keep2 and Q == MAIN_Q:
                        # The mode the main path runs at Q <= 64; _int_mm
                        # on the int4 codes is the library's product.
                        q8, _ = ft.quantize_rows_int8(q)
                        k4_cols = columns(k4_bound(Q, live, count, 1024, deferred),
                                          int_mm_ms(q8, c4.t(), "K4"))
    main = res[(8, True, False, MAIN_Q)]
    out["fused_topk_int4q"] = {"max_abs_err": worst, "ms": main[0], "plain_ms": main[1],
                               **k4_cols}
    del codes, scales, packed, alive, c4
    torch.cuda.empty_cache()
    for name, st in out.items():
        lib = "null" if st["library_ms"] is None else f"{st['library_ms']:.4f}"
        print(f"[{label}] phase1 {name} Q={MAIN_Q} kernel_ms={st['ms']:.4f} bound_ms="
              f"{st['bound_ms']:.4f} ({st['bound_by']}) library_ms={lib}", flush=True)
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
    from memex_tpu_torch.text.tokenizer import _build_fallback_vocab
    from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig, save_params

    cfg = MiniLMConfig()  # 12 layers, 384 hidden, 12 heads, 1536 FFN, 512 pos, 30522 vocab
    save_params(model_dir, cfg, MiniLM(cfg).init_random(seed), vocab=_build_fallback_vocab())


@contextlib.contextmanager
def port_server(work: str, name: str, env: dict, device: str = "cuda"):
    """`memex_tpu_torch serve --roles Api,Worker` in `work` under `env`
    (HOST, PORT and PYTHONPATH set here), logging to server_{name}.log;
    yields its base URL once /api/health answers. A failure inside prints
    the log's tail; the server is stopped on the way out."""
    port = free_port()
    env = dict(env, HOST="127.0.0.1", PORT=str(port),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log_path = os.path.join(work, f"server_{name}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "memex_tpu_torch", "serve", "--roles", "Api,Worker",
             "--device", device], cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 300
        while True:
            check(proc.poll() is None, f"server exited with {proc.returncode}")
            try:
                http("GET", f"{base}/api/health", timeout=5)
                break
            except OSError:
                check(time.monotonic() < deadline, "server did not come up in 300s")
                time.sleep(0.5)
        yield base
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


def phase2(label: str, seed: int, work: str, store: str, kernel: str, scheme: str = "tpu",
           n_docs: int = 100, model: str = "model", clients: int = 32,
           tag: str = "phase2") -> int:
    """One server run on VECTOR_CONNECTION={scheme}://{work}/{store} with
    n_docs documents and EMBEDDING_MODEL={work}/{model}; returns the
    launches of `kernel` its searches (from `clients` clients) made. An
    IVF store's searches wait for the Maintain tasks its ingest queued."""
    model_dir = os.path.join(work, model)
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    name = store.split("?")[0]
    db_path = os.path.join(work, f"{name}.db")
    env = dict(os.environ, EMBEDDING_MODEL=model_dir,
               DATABASE_CONNECTION=f"sqlite://{db_path}",
               VECTOR_CONNECTION=f"{scheme}://{work}/{store}", MEMEX_FAKE_LLM="1")
    with port_server(work, name, env) as base:
        return _drive_server(f"{label}] [{scheme}://{store}", seed, base, kernel, n_docs,
                             db_path if scheme == "tpu+ivf" else None, clients, tag)


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


def _drive_server(label: str, seed: int, base: str, kernel: str, n_docs: int,
                  maintain_db: str | None, clients: int = 32, tag: str = "phase2") -> int:
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
    print(f"[{label}] {tag} ingest docs={len(docs)} seconds={ingest_s:.3f} "
          f"docs_per_s={len(docs) / ingest_s:.2f}", flush=True)
    if maintain_db:
        wait_maintenance(label, maintain_db)

    before = _launches(base, kernel)
    limit, per_client = 10, 4
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
    print(f"[{label}] {tag} search requests={len(runs)} clients={clients} "
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
# The tiers phase 5 shards: one for each of K1-K4.
SHARDED_TIERS = ("float32", "int8", "int8-bf16-queries", "int4")


def search_ms(index, q_np, runs: int = 10) -> float:
    """Median host-clock ms of index.search(q_np, 10) (it ends in the copy
    back of the hits), after one warmup call."""
    index.search(q_np, 10)
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        index.search(q_np, 10)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase3(label: str, seed: int, work: str) -> tuple[dict, dict]:
    """Each tier's 1M-row index in turn (freed before the next). Returns
    the launches each kernel made in its tiers' searches, and for phase 5
    the rows, queries, oracle, and each sharded tier's unsharded hits and
    FlatIndex.search times."""
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
    flat = {"rows": base_np, "queries": q_np, "oracle": oracle, "src": src, "hits": {}, "ms": {}}
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
        if name in SHARDED_TIERS:
            flat["hits"][name] = hits
            flat["ms"][name] = {Q: search_ms(index, q_np[:Q]) for Q in TIMED_Q}
            times = " / ".join(f"{flat['ms'][name][Q]:.3f}" for Q in TIMED_Q)
            print(f"[{label}] phase3 {name} FlatIndex.search median_ms at Q=1/32/128 "
                  f"{times}", flush=True)
        if name in TIMED_TIERS:
            launches[kernel] += time_query_path(label, name, fqp, store, texts, kernel)
        del store, index
        torch.cuda.empty_cache()
    return launches, flat


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


def oracle_scores(q, corpus, k: int = IVF_K, block: int = 1 << 20):
    """Exact float32 top-k (values, ids) of q against the corpus, blockwise,
    on the card."""
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
    return best_v, best_i


def oracle_topk(q, corpus, k: int = IVF_K, block: int = 1 << 20):
    """Exact float32 top-k ids of q against the corpus, blockwise."""
    return oracle_scores(q, corpus, k, block)[1].cpu().numpy()


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


def phase4(label: str, seed: int, work: str) -> tuple[dict, dict, dict]:
    """The IVF tier on the card. Returns (launches of K6 and K7 in
    IVFIndex.search, kernel stats of K5-K7, and for phase 5 the 10M
    corpus's device codes, queries, oracle and IVFIndex.search times)."""
    import numpy as np
    import torch

    from memex_tpu_torch.embed import EmbeddingEngine
    from memex_tpu_torch.index.ivf import IVFIndex, _route
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops import ivf_batch as ib
    from memex_tpu_torch.ops import ivf_batch4 as ib4
    from memex_tpu_torch.ops import ivf_scan as isc
    from memex_tpu_torch.scan_bench import k5_bound, k6_bound, k7_bound
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
    C, M, _ = index.data.shape
    data4, rsc4 = index._int4_mirror()
    print(f"[{label}] phase4 10M build_device seconds={time.perf_counter() - t0:.3f} C={C} "
          f"M={M} spill_rows={index.spill.count} device_gb={index_gb(index):.3f}", flush=True)

    flat, fsc = index.data.view(-1, DIM), index.rscales.view(-1)
    stats, res, cols = {}, {}, {}
    for Q in (1, 32, 128):
        q = queries[:Q].contiguous()
        clist, nact = ib.route_union(index.centroids, q, index.nprobe)
        walk, n_chunks = ib._chunk_walk(index.sizes, clist, nact, M, 1024)
        n_ch = int(n_chunks[0])
        q16 = q.bfloat16().float()
        col, ok = ib._union_columns(walk, n_chunks, index.sizes, M, 1024)
        union = col[ok]  # the union's live rows
        n_live = int(union.numel())

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
            if not keep2 and Q == MAIN_Q:
                rows16, qb = flat[union].bfloat16(), q.bfloat16()
                cols["ivf_batch"] = columns(k5_bound(Q, n_live, n_ch, DIM + 4, 1024, C),
                                            cuda_ms(lambda: torch.matmul(qb, rows16.T)))
                del rows16

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
        print(f"[{label}] phase4 K7 int8 S=256 Q={Q} (off K7's path) probed_rows={live} "
              f"bytes={n_bytes} "
              f"max_abs_err={err:.3e} slot_idx_diff={n_diff} kernel_ms={ms:.4f} (bank only "
              f"{bank_ms:.4f}) plain_ms={p_ms:.4f} row_read_GBps={gbps(n_bytes, bank_ms)}",
              flush=True)
        res[("ivf_probe", False, Q)] = (err, ms, p_ms)
        if Q == MAIN_Q:
            # Each probed bucket read once, each query against its own
            # probes; the yardstick scores every query's whole buckets.
            probed = torch.unique(probes.long())
            rows_read = int(index.sizes.long()[probed].sum())
            buckets = index.data[probes.long()].reshape(Q, -1, DIM).bfloat16()
            qb = q.bfloat16()[:, None, :]
            cols["ivf_probe"] = columns(
                k7_bound(Q, rows_read, live, probes.numel(), DIM + 4, 256, C),
                cuda_ms(lambda: torch.bmm(qb, buckets.transpose(1, 2))))
            del buckets

    # K6 on the int4 mirror, at both chunk widths the index can run (S =
    # 1024, the 10M index's own mirror, and 512), keep2 off and on, at the
    # batch sizes around the body's tile widths; timed at S = 1024.
    hi4 = torch.clamp((flat.to(torch.int32) + 8) >> 4, -7, 7).to(torch.int8)
    rs4 = rsc4.view(-1)
    for banks in (8, 4):
        S = banks * 128
        mirror = data4 if banks == 8 else ib4.pack_int4_buckets(index.data, index.rscales,
                                                                 banks=banks)[0]
        for Q in TILE_Q:
            q = queries[:Q].contiguous()
            q16 = q.bfloat16().float()
            clist, nact = ib.route_union(index.centroids, q, index.nprobe)
            walk, n_chunks = ib._chunk_walk(index.sizes, clist, nact, M, S)
            n_ch = int(n_chunks[0])
            args4 = (mirror, rsc4, index.sizes, walk, n_chunks, q)

            def score4(qi, idx):
                return (q16[qi] * hi4[idx].float()).sum(1) * rs4[idx]

            for keep2 in (False, True):
                bank = ib4.ivf_batch4_bank_cuda(*args4, banks=banks, keep2=keep2)
                plain = ib4.ivf_batch4_bank_reference(*args4, banks=banks, keep2=keep2)
                torch.cuda.synchronize()
                err, n_diff = compare_bank(bank, plain, score4)
                res[("ivf_batch4", banks, keep2, Q)] = (err, None, None)
                what = (f"S={S} keep2={keep2} Q={Q} chunks={n_ch} max_abs_err={err:.3e} "
                        f"slot_idx_diff={n_diff}")
                if banks != 8 or keep2 or Q not in TIMED_Q:
                    print(f"[{label}] phase4 K6 int4 {what}", flush=True)
                    continue
                ms = cuda_ms(lambda: ib4.ivf_batch_topk4(mirror, rsc4, index.sizes, clist, nact,
                                                          q, 1024, banks=8))
                bank_ms = cuda_ms(lambda: ib4.ivf_batch4_bank_cuda(*args4, banks=8))
                p_ms = plain_ms(lambda: ft._bank_topk(
                    *ib4.ivf_batch4_bank_reference(*args4, banks=8), 1024))
                n_bytes = n_ch * 1024 * (DIM // 2 + 4)
                print(f"[{label}] phase4 K6 int4 {what} bytes={n_bytes} kernel_ms={ms:.4f} "
                      f"(bank only {bank_ms:.4f}) plain_ms={p_ms:.4f} "
                      f"row_read_GBps={gbps(n_bytes, bank_ms)}", flush=True)
                res[("ivf_batch4", False, Q)] = (err, ms, p_ms)
                if Q == MAIN_Q:
                    col, ok = ib._union_columns(walk, n_chunks, index.sizes, M, 1024)
                    union = col[ok]
                    # A packed row is live with its first row: the first
                    # half of each chunk's columns.
                    live_packed = int(ok.view(n_ch, 1024)[:, :512].sum())
                    rows16, qb = hi4[union].bfloat16(), q.bfloat16()
                    cols["ivf_batch4"] = columns(
                        k6_bound(Q, live_packed, int(union.numel()), n_ch, 1024, C),
                        cuda_ms(lambda: torch.matmul(qb, rows16.T)))
                    del rows16
        del mirror
    del hi4
    for name in ("ivf_batch", "ivf_batch4", "ivf_probe"):
        mine = [v for key, v in res.items() if key[0] == name]
        main = res[(name, False, MAIN_Q)]
        stats[name] = {"max_abs_err": max(v[0] for v in mine), "ms": main[1],
                       "plain_ms": main[2], **cols[name]}
        print(f"[{label}] phase4 {name} Q={MAIN_Q} bound_ms={cols[name]['bound_ms']:.4f} "
              f"({cols[name]['bound_by']}) library_ms={cols[name]['library_ms']:.4f}", flush=True)

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
    ivf10m = {"codes": codes, "scales": scales, "queries": queries, "oracle": oracle,
              "ms": {Q: search_ms(index, q_np[:Q]) for Q in TIMED_Q}}
    times = " / ".join(f"{ivf10m['ms'][Q]:.3f}" for Q in TIMED_Q)
    print(f"[{label}] phase4 10M IVFIndex.search median_ms at Q=1/32/128 {times}", flush=True)
    del codes, scales

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
            ("int8-4-clusters", {"dtype": "int8"}, "ivf_probe", 0.93, dict(n_clusters=4), 32)):
        t0 = time.perf_counter()
        index = IVFIndex(DIM, nprobe=64, bucket_factor=1.2, device=dev, **kw, **opts)
        index.build(base_np, ids)
        torch.cuda.synchronize()
        if kernel == "ivf_probe":
            # k-means is a fixed function of its seed: a second build gives
            # the same centroids bit for bit, so this index has one recall.
            again = IVFIndex(DIM, nprobe=64, bucket_factor=1.2, device=dev, **kw, **opts)
            again.build(base_np, ids)
            same = torch.equal(index.centroids, again.centroids)
            print(f"[{label}] phase4 1M {name} two builds from one seed: centroids "
                  f"bit_equal={same}", flush=True)
            check(same, f"1M IVF {name}: two k-means fits from one seed differ")
            del again
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
            # K7's kernels-line entry is this index's: it is K7's path.
            own = compare_probe_scan(label, name, index, q1[:n_q])
            err = max(own.pop("max_abs_err"), stats[kernel]["max_abs_err"])
            stats[kernel].update(own)
        elif index.dtype == "float32":
            err = compare_float_scan(label, name, index, q1)
        else:
            err = 0.0  # K5 keep2 on int8 rows: held at 10M above
        stats[kernel]["max_abs_err"] = max(stats[kernel]["max_abs_err"], err)
        del index
        torch.cuda.empty_cache()
    return launches, stats, ivf10m


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


def compare_probe_scan(label: str, name: str, index, q, block: int = 8) -> dict:
    """K7 on the index's own probes against the plain version, which runs
    `block` queries at a time (a query's plain bank holds its probes' whole
    buckets in float32), at Q = 1 and at the batch of q. Returns the kernels
    line's entry for K7, whose path this index is: the max abs error, and
    at the batch of q the top-k wrapper's and the plain version's ms, the
    bound and the library call (bf16 torch.matmul against the probed union,
    the same product where every query probes every cluster)."""
    import torch

    from memex_tpu_torch.index.ivf import _route
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops import ivf_scan as isc
    from memex_tpu_torch.scan_bench import k7_bound

    flat, fsc = index.data.view(-1, DIM), index.rscales.view(-1)
    C, M = index.data.shape[:2]
    out = {"max_abs_err": 0.0}
    for n_q in (1, q.shape[0]):
        qq = q[:n_q].contiguous()
        probes = _route(index.centroids, qq, index.nprobe).to(torch.int32)
        args = (index.data, index.rscales, index.sizes, probes, qq)

        def plain_bank():
            parts = [isc.ivf_probe_bank_reference(index.data, index.rscales, index.sizes,
                                                  probes[lo : lo + block], qq[lo : lo + block])
                     for lo in range(0, n_q, block)]
            return tuple([torch.cat([p[j][0] for p in parts])] for j in (0, 1))

        bank = isc.ivf_probe_bank_cuda(*args)
        plain = plain_bank()
        # The work list the kernel builds, against its plain version.
        T, n_tiles = isc.probe_plan(n_q, probes.shape[1], C, M, 256)[:2]
        got = isc.probe_work_list(probes, C, T, n_tiles)
        want = isc.probe_work_list(probes.cpu(), C, T, n_tiles)
        torch.cuda.synchronize()
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"1M {name}: K7's work list differs from its plain version at Q={n_q}")
        q16 = qq.bfloat16().float()
        err, n_diff = compare_bank(bank, plain, lambda qi, idx: (
            q16[qi] * flat[idx].float()).sum(1) * fsc[idx])
        out["max_abs_err"] = max(out["max_abs_err"], err)
        bank_ms = cuda_ms(lambda: isc.ivf_probe_bank_cuda(*args))
        live = int(index.sizes.long()[probes.long()].sum())
        print(f"[{label}] phase4 1M {name} K7 int8 S=256 Q={n_q} nprobe={probes.shape[1]} "
              f"M={M} probed_rows={live} max_abs_err={err:.3e} slot_idx_diff={n_diff} "
              f"bank_ms={bank_ms:.4f} row_read_GBps={gbps(live * (DIM + 4), bank_ms)}",
              flush=True)
        if n_q == 1:
            continue
        out["ms"] = cuda_ms(lambda: isc.ivf_probe_topk(*args[:4], qq, IVF_K))
        out["plain_ms"] = plain_ms(lambda: ft._bank_topk(*plain_bank(), IVF_K))
        probed = torch.unique(probes.long())
        sizes = index.sizes.long()
        union = torch.cat([index.data[c, : int(sizes[c])] for c in probed.tolist()]).bfloat16()
        qb = qq.bfloat16()
        out.update(columns(k7_bound(n_q, int(sizes[probed].sum()), live, probes.numel(),
                                    DIM + 4, 256, C),
                           cuda_ms(lambda: torch.matmul(qb, union.T))))
        del union
        print(f"[{label}] phase4 1M {name} K7 Q={n_q} kernel_ms={out['ms']:.4f} "
              f"plain_ms={out['plain_ms']:.4f} bound_ms={out['bound_ms']:.4f} "
              f"({out['bound_by']}) library_ms={out['library_ms']:.4f}", flush=True)
    return out

# -- phase 5 -------------------------------------------------------------------

# Shards of the sharded indexes, all on the one card: each is its own
# block of tensors with its own scan launches, as on four cards.
SHARDS = 4


def hit_rows(index, hits):
    """Global rows of a sharded flat index's hits, [Q, k] on the host."""
    import numpy as np

    return np.asarray([[index._id_to_row[sid] for sid, _ in h] for h in hits])


def tier_scores(kernel: str, q, rows, scales):
    """Each hit's score under its tier's arithmetic, from the stored rows
    (float32 rows, or int8 codes and their scales): K1 bf16 inputs with
    float32 sums; K2 the exact integer dot times the row, then the query
    scale; K3 and K4's int8 rerank bf16 queries against the codes times
    the row scale."""
    from memex_tpu_torch.ops import fused_topk as ft

    if kernel == "fused_topk_int8q":
        q8, qs = ft.quantize_rows_int8(q)
        return (q8[:, None, :].float() * rows.float()).sum(-1) * scales * qs[:, None]
    q16 = q.bfloat16().float()[:, None, :]
    if kernel == "fused_topk":
        return (q16 * rows.bfloat16().float()).sum(-1)
    return (q16 * rows.float()).sum(-1) * scales


def shard_bank_check(label: str, name: str, kernel: str, index, q, shard: int = 0,
                     tag: str = "phase5") -> float:
    """A shard's bank at the sharded search's call parameters against its
    plain version (K2 and K4 bit-equal, K1 and K3 by compare_bank's rule).
    Returns the max abs error."""
    import torch

    from memex_tpu_torch.ops import fused_topk as ft

    buf, count = index.bufs[shard], index.counts[shard]
    scales = None if index.scales is None else index.scales[shard]
    err, what = 0.0, "bit_equal=True"
    if kernel == "fused_topk_int8q":
        q8, _ = ft.quantize_rows_int8(q)
        bank = ft.fused_score_bank_int8q_cuda(buf, scales, q8, count, banks=4)
        plain = ft.int8q_bank_reference(buf, scales, q8, count, banks=4)
        bit_equal(bank[0] + bank[1], plain[0] + plain[1], f"{name} shard {shard}")
    elif kernel == "fused_topk_int4q":
        kw = dict(banks=8, deferred=q.shape[0] <= 64)
        bit_equal(list(ft.int4q_candidates_cuda(buf, scales, q, count, **kw)),
                  list(ft.int4q_candidates_reference(buf, scales, q, count, **kw)),
                  f"{name} shard {shard}")
    else:
        q16 = q.bfloat16().float()
        if kernel == "fused_topk":
            bank = ft.fused_score_bank_cuda(buf, q, count, banks=8)
            plain = ft._fold_bank(ft.scores_f32(q, buf[:count].T, False), None, 1024, False)

            def score_of(qi, rows):
                return (q16[qi] * buf[rows].bfloat16().float()).sum(1)
        else:
            bank = ft.fused_score_bank_int8_cuda(buf, scales, q, count, banks=8)
            plain = ft.int8_bank_reference(buf, scales, q, count, banks=8)

            def score_of(qi, rows):
                return (q16[qi] * buf[rows].float()).sum(1) * scales[rows]
        torch.cuda.synchronize()
        err, n_diff = compare_bank(bank, plain, score_of)
        what = f"max_abs_err={err:.3e} slot_idx_diff={n_diff}"
    print(f"[{label}] {tag} {name} shard {shard} of {index.P} ({count} rows) {kernel} bank Q="
          f"{q.shape[0]} vs plain: {what}", flush=True)
    return err


def ivf_shard_bank_check(label: str, tag: str, index, q, shard: int = 0) -> float:
    """A ShardedIVFIndex shard's K5 bank at its own masked probes against
    its plain version. Returns the max abs error."""
    import torch

    from memex_tpu_torch.index.sharded_ivf import _shard_mask
    from memex_tpu_torch.ops import ivf_batch as ib

    dev, Cp, M = q.device, index.Cp, index.M
    mask = _shard_mask(index._cent[shard], q, index.nprobe, None, shard * Cp, Cp)
    order = torch.argsort(torch.where(mask, torch.arange(Cp, device=dev),
                                      Cp + torch.arange(Cp, device=dev)))
    nact = mask.sum(dtype=torch.int32).reshape(1)
    walk, n_chunks = ib._chunk_walk(index.sizes[shard], order.to(torch.int32), nact, M, 1024)
    args = (index.data[shard], index.rscales[shard], index.sizes[shard], walk, n_chunks, q)
    bank = ib.ivf_batch_bank_cuda(*args, banks=8)
    plain = ib.ivf_batch_bank_reference(*args, banks=8)
    torch.cuda.synchronize()
    flat, fsc = index.data[shard].view(-1, DIM), index.rscales[shard].view(-1)
    q16 = q.bfloat16().float()
    err, n_diff = compare_bank(bank, plain, lambda qi, idx: (
        q16[qi] * flat[idx].float()).sum(1) * fsc[idx])
    print(f"[{label}] {tag} shard {shard} of {index.P} K5 bank Q={q.shape[0]} union_clusters="
          f"{int(nact[0])} chunks={int(n_chunks[0])} vs plain: max_abs_err={err:.3e} "
          f"slot_idx_diff={n_diff}", flush=True)
    return err


def phase5(label: str, seed: int, work: str, flat: dict, ivf10m: dict) -> tuple[dict, dict]:
    """The sharded tiers, four shards on the card: ShardedFlatIndex on
    phase 3's rows in each of K1-K4's tiers, ShardedIVFIndex at the 10M
    configuration built from phase 4's device codes, and the HTTP server on
    a `tpu+mesh://` int8 store. Returns (each kernel's launches on this
    path, its worst shard-bank error)."""
    import numpy as np
    import torch

    from memex_tpu_torch.index.sharded import ShardedFlatIndex
    from memex_tpu_torch.index.sharded_ivf import ShardedIVFIndex
    from memex_tpu_torch.ops import fused_topk as ft

    dev = torch.device("cuda")
    devices = [dev] * SHARDS
    launches = dict.fromkeys(ft.LAUNCHES, 0)
    errs: dict[str, float] = {}
    base_np, q_np, oracle, src = flat["rows"], flat["queries"], flat["oracle"], flat["src"]
    q = torch.from_numpy(q_np).to(dev)
    ids = [f"r{i}" for i in range(N_ROWS)]
    for name, opts, kernel, bar in (t for t in TIERS if t[0] in SHARDED_TIERS):
        t0 = time.perf_counter()
        index = ShardedFlatIndex(DIM, devices, capacity_per_shard=N_ROWS // SHARDS, **opts)
        index.add(base_np, ids)
        torch.cuda.synchronize()
        print(f"[{label}] phase5 {name} ShardedFlatIndex shards={SHARDS} cap={index.cap} "
              f"counts={index.counts} bulk load seconds={time.perf_counter() - t0:.3f}",
              flush=True)
        ft.reset_launches()
        hits = index.search(q_np, 10)
        n = ft.LAUNCHES[kernel]
        check(n == SHARDS, f"sharded {name}: one search launched {kernel} {n}x, not {SHARDS}")
        launches[kernel] += n
        rows = hit_rows(index, hits)
        stored = torch.from_numpy(index._sh_rows[rows]).to(dev)
        scales = (torch.from_numpy(index._sh_scales[rows]).to(dev)
                  if index._sh_scales is not None else None)
        got = torch.tensor([[v for _, v in h] for h in hits], device=dev)
        score_err = (got - tier_scores(kernel, q, stored, scales)).abs().max().item()
        top1 = np.mean([h[0][0] == f"r{s}" for h, s in zip(hits, src)])
        recall = np.mean([len({x for x, _ in h} & {f"r{int(j)}" for j in o}) / 10
                          for h, o in zip(hits, oracle)])
        overlap = np.mean([len({x for x, _ in h} & {x for x, _ in u}) / 10
                           for h, u in zip(hits, flat["hits"][name])])
        print(f"[{label}] phase5 {name} ShardedFlatIndex.search Q=128 {kernel}_launches={n} "
              f"hit_score_max_abs_err={score_err:.3e} source_row_first={top1:.4f} "
              f"recall_at_10_vs_f32_oracle={recall:.4f} overlap_at_10_with_FlatIndex="
              f"{overlap:.4f} (bar {bar})", flush=True)
        check(score_err <= SCORE_TOL, f"sharded {name}: hit scores {score_err:.3e} off")
        check(top1 >= 0.99, f"sharded {name}: source row first for only {top1:.4f}")
        check(recall >= bar, f"sharded {name}: recall@10 {recall:.4f} < {bar}")
        check(overlap >= bar, f"sharded {name}: overlap with FlatIndex {overlap:.4f} < {bar}")
        errs[kernel] = shard_bank_check(label, name, kernel, index, q[:MAIN_Q])
        for Q in TIMED_Q:
            ms = search_ms(index, q_np[:Q])
            print(f"[{label}] phase5 {name} search Q={Q} median_ms sharded={ms:.3f} "
                  f"unsharded={flat['ms'][name][Q]:.3f}", flush=True)
        del index, stored
        torch.cuda.empty_cache()

    # The 10M IVF configuration, its clusters over four shards.
    codes, scales = ivf10m.pop("codes"), ivf10m.pop("scales")
    queries = ivf10m["queries"]
    t0 = time.perf_counter()
    index = ShardedIVFIndex(DIM, devices, **{k: v for k, v in IVF_10M.items() if k != "dtype"})
    index.build_device(codes, scales, list(range(N_10M)))
    torch.cuda.synchronize()
    del codes, scales
    torch.cuda.empty_cache()
    M = index.M
    print(f"[{label}] phase5 10M ShardedIVFIndex build_device seconds="
          f"{time.perf_counter() - t0:.3f} shards={SHARDS} C={index.C} Cp={index.Cp} M={M} "
          f"spill_rows={index.spill.count}", flush=True)
    q_ivf = queries.cpu().numpy()
    ft.reset_launches()
    hits = index.search(q_ivf, IVF_K)
    n = ft.LAUNCHES["ivf_batch"]
    check(n == SHARDS, f"sharded 10M IVF: one search launched K5 {n}x, not {SHARDS}")
    launches["ivf_batch"] += n
    launches["fused_topk_int8q"] += ft.LAUNCHES["fused_topk_int8q"]  # the spill's, if any
    rec = recall_at_k(hits, ivf10m["oracle"])
    print(f"[{label}] phase5 10M ShardedIVFIndex.search Q=128 ivf_batch_launches={n} "
          f"recall_at_10_vs_f32_oracle={rec:.4f} (bar 0.93)", flush=True)
    check(rec >= 0.93, f"sharded 10M IVF: recall@10 {rec:.4f} < 0.93")
    errs["ivf_batch"] = ivf_shard_bank_check(label, "phase5 10M", index,
                                             queries[:MAIN_Q].contiguous())
    for Q in TIMED_Q:
        ms = search_ms(index, q_ivf[:Q])
        print(f"[{label}] phase5 10M search Q={Q} median_ms sharded={ms:.3f} "
              f"unsharded={ivf10m['ms'][Q]:.3f}", flush=True)
    del index
    torch.cuda.empty_cache()

    # The server on a sharded int8 store (one shard a card: one on this machine).
    launches["fused_topk_int8q"] += phase2(label, seed, work, "vectors_mesh?dtype=int8",
                                           "fused_topk_int8q", scheme="tpu+mesh")
    return launches, errs


# -- phase 6 -------------------------------------------------------------------
# The local LLM (memex_tpu_torch/llm/local/) at the widths memex_tpu ships and
# benchmarks, with seeded random weights drawn on the card: TinyLlama-1.1B
# (memex_tpu/benchmarks/llm_bench.py:88-90, GQA 32 over 4), Llama-2-7B
# (LlamaConfig(), bf16 and int8) and GPT-J-6B (GptJConfig()).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
LLM_P = 128           # prompt tokens (llm_bench.py's --prompt-len)
LLM_NEW = 128         # new tokens timed (llm_bench.py's --max-new)
LLM_GREEDY_NEW = 36   # greedy stream vs generate: the first chunk, two more, a spill
LLM_CHECK_STEPS = 8   # cached decode steps held against one prefill
LLM_CUT_LAYERS = 2    # depth of the copy run on the card and on the CPU
LLM_CUT_T = 16
# Card vs CPU, float32, two layers at full width. Both sides' float32
# products agree to ~3e-7 relative (a [16, 4096] x [4096, 11008] matmul
# against float64 on each), but the KV cache is bf16 even in float32
# compute (memex_tpu's design), so a key or value an ulp apart on the two
# sides can round to neighbouring bf16 values (2^-8 relative apart), which
# moves logits (std ~1.3, |max| ~6) by up to ~1.5e-3 (measured). 1e-2 is
# loose for that and tight against a fault of masking, rotary, layout or
# the cache, each of which moves logits by O(0.1-1).
LLM_CPU_TOL = 1e-2
# Cosine of each position's logits against float32: bf16 weights and
# activations round each product's inputs to 8 bits of mantissa. With
# random weights every layer amplifies a perturbation of its input, so the
# cosine falls with depth (Llama-2-7B bf16: 0.99987 after one layer,
# 0.99656 after 32). int8 is held to the float32 model of the weights it
# stores (its own tree in float32 compute) at bf16's bar, after every code
# is checked to lie within half a step of its weight; against the original
# float32 model it only prints, since there the quantization noise itself
# is amplified (0.99867 after one layer, 0.96262 after 32; the float32
# model of the dequantized weights reads 0.96621, so it is not the int8
# path's arithmetic).
LLM_DTYPE_COS = 0.99
LLM_DECODE_COS = 0.99   # cached decode against one prefill, per position


# Depth of the 7B-class runs (Llama-2-7B has 32 layers, GPT-J-6B 28): every
# width is the published one, and every check runs, but the smoke's time
# budget holds a quarter of their layers. TinyLlama runs at full depth.
LLM_7B_LAYERS = 4


def llm_models():
    from memex_tpu_torch.llm.local.gptj import GptJConfig
    from memex_tpu_torch.llm.local.model import LlamaConfig

    return (
        ("TinyLlama-1.1B", LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=22,
                                       num_heads=32, num_kv_heads=4, intermediate_size=5632,
                                       max_context=2048), ("bfloat16",)),
        ("Llama-2-7B", LlamaConfig(num_layers=LLM_7B_LAYERS), ("bfloat16", "int8")),
        ("GPT-J-6B", GptJConfig(num_layers=LLM_7B_LAYERS), ("bfloat16",)),
    )


def min_cosine(a, b) -> float:
    """Smallest per-position cosine of two [T, V] logit tables."""
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()


def first_layers(params, n: int) -> dict:
    """Views of the first n layers' weights (int8 leaves keep their form)."""
    return {k: ({lk: ({"q": lv["q"][:n], "s": lv["s"][:n]} if isinstance(lv, dict) else lv[:n])
                 for lk, lv in v.items()} if k == "layers" else v)
            for k, v in params.items()}


def prompt_logits(cfg, params, prompt):
    """[P, V] float32 logits of one prefill over the prompt."""
    import torch

    from memex_tpu_torch.llm.local.model import init_cache, model_forward

    P = prompt.shape[1]
    cache = init_cache(cfg, device=prompt.device)
    logits, _ = model_forward(cfg, params, prompt,
                              torch.arange(P, device=prompt.device)[None], cache, 0)
    return logits[0]


def card_vs_cpu(label: str, name: str, cfg, params32, prompt) -> float:
    """(a) The first LLM_CUT_LAYERS layers at full width, float32, a
    prefill of LLM_CUT_T tokens and one cached decode step, on the card
    and on the CPU."""
    import dataclasses

    import torch

    from memex_tpu_torch.llm.local.model import init_cache, model_forward

    cfg2 = dataclasses.replace(cfg, num_layers=LLM_CUT_LAYERS, compute_dtype="float32")
    cut = first_layers(params32, LLM_CUT_LAYERS)
    T = LLM_CUT_T

    def run(p, dev):
        ids = prompt[:, : T + 1].to(dev)
        cache = init_cache(cfg2, device=dev)
        lg, cache = model_forward(cfg2, p, ids[:, :T], torch.arange(T, device=dev)[None],
                                  cache, 0)
        st, _ = model_forward(cfg2, p, ids[:, T:], torch.full((1, 1), T, device=dev), cache,
                              torch.full((), T, device=dev))
        return torch.cat([lg[0], st[0]]).cpu()

    cpu = torch.device("cpu")
    on_card = run(cut, prompt.device)
    on_cpu = run({k: ({lk: lv.to(cpu) for lk, lv in v.items()} if isinstance(v, dict)
                      else v.to(cpu)) for k, v in cut.items()}, cpu)
    err = (on_card - on_cpu).abs().max().item()
    print(f"[{label}] phase6 {name} float32 {LLM_CUT_LAYERS}-layer copy card vs cpu "
          f"T={T}+1 max_abs_err={err:.3e} (tol {LLM_CPU_TOL}) "
          f"max_abs_logit={on_cpu.abs().max().item():.3f}", flush=True)
    check(err <= LLM_CPU_TOL, f"{name}: card and CPU logits differ by {err:.3e}")
    return err


def decode_vs_prefill(cfg, params, prompt, full) -> float:
    """(b) Prefill P - LLM_CHECK_STEPS tokens, then decode the rest one
    token a step: smallest cosine against one prefill's logits."""
    import torch

    from memex_tpu_torch.llm.local.model import init_cache, model_forward

    dev = prompt.device
    P = prompt.shape[1]
    S = P - LLM_CHECK_STEPS
    cache = init_cache(cfg, device=dev)
    _, cache = model_forward(cfg, params, prompt[:, :S], torch.arange(S, device=dev)[None],
                             cache, 0)
    steps = []
    for t in range(S, P):
        lg, cache = model_forward(cfg, params, prompt[:, t:t + 1],
                                  torch.full((1, 1), t, device=dev), cache,
                                  torch.full((), t, device=dev))
        steps.append(lg[0, 0])
    return min_cosine(torch.stack(steps), full[S:])


def check_codes(params32, params8) -> int:
    """Every int8 code times its scale lies within half a step (s / 2) of
    the float32 weight it codes, give or take the float32 rounding of w / s
    and q * s (a few ulps of w): per out-channel for the products, per row
    for the embedding. Checked a layer at a time; returns the count."""
    import torch

    def within(w, q, s):
        err = (q.to(torch.float32) * s - w).abs()
        check(bool((err <= s * 0.5 + w.abs() * 2.0 ** -21).all()),
              "an int8 code is off its weight")
        return w.numel()

    n = 0
    for k, v in params8.items():
        if k == "layers":
            for lk, lv in v.items():
                if isinstance(lv, dict):
                    for i in range(lv["q"].shape[0]):
                        n += within(params32[k][lk][i], lv["q"][i], lv["s"][i][None, :])
        elif isinstance(v, dict):
            n += within(params32[k], v["q"], v["s"][:, None] if k == "embed" else v["s"][None, :])
    return n


def step_bytes(cfg, params) -> tuple[int, int]:
    """(weight bytes, KV bytes) one decode step reads: every weight once
    (one row of the embedding), and the whole static cache, K and V."""
    def leaves(tree):
        for k, v in tree.items():
            if isinstance(v, dict) and k != "embed":
                yield from leaves(v)
            else:
                yield k, v

    weights = 0
    for k, v in leaves(params):
        if k == "embed":   # a gather of one row
            parts = v.values() if isinstance(v, dict) else [v]
            weights += sum(p[0].numel() * p.element_size() for p in parts)
        else:
            weights += v.numel() * v.element_size()
    kv = 2 * cfg.num_layers * cfg.max_context * cfg.num_kv_heads * cfg.head_dim * 2
    return weights, kv


def matmul_params(params) -> int:
    """Weights that multiply activations (the embedding gather does not)."""
    from memex_tpu_torch.llm.local.model import _MATMUL_KEYS

    def count(tree):
        n = 0
        for k, v in tree.items():
            if k in _MATMUL_KEYS:
                n += (v["q"] if isinstance(v, dict) else v).numel()
            elif k == "layers":
                n += count(v)
        return n

    return count(params)


class _NoEos:
    """A tokenizer with no end token: timed decodes run every step."""

    eos_id = -1


def stream_times(llm, prompt, max_new: int) -> dict:
    """llm_bench.py's stream_decode_bench on the port: a timed prefill (read
    back), then chunks enqueued one ahead of the read of the last, through
    LocalLLM._enqueue (pinned copy + event). First token: prefill + the
    first chunk's read."""
    from memex_tpu_torch.llm.local.model import prefill

    P = prompt.shape[1]
    t0 = time.perf_counter()
    carry = prefill(llm.cfg, llm.params, prompt, P, llm.sampler)
    carry[1][:1].tolist()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n, first = 0, None
    pending = llm._enqueue(carry, llm.FIRST_CHUNK)
    dispatched = llm.FIRST_CHUNK
    while n < max_new:
        carry, host, ready = pending
        if dispatched < max_new:
            pending = llm._enqueue(carry, llm.STREAM_CHUNK)
            dispatched += llm.STREAM_CHUNK
        if ready is not None:
            ready.synchronize()
        n += len(host.tolist()[0])
        if first is None:
            first = time.perf_counter() - t0
    stream_s = time.perf_counter() - t0
    return {"prefill_s": prefill_s, "stream_s": stream_s, "n": n, "first_s": first}


def device_events(prof) -> list:
    """The trace's device events, without the ranges that record_function
    annotations (torch.optim's `Optimizer.step#...`) add to the device
    timeline: those span the kernels they enclose and the gaps between."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy(fn) -> tuple[float, float, int]:
    """(device ms, wall ms, kernels) of fn(): the union of the kernels'
    intervals in a torch.profiler trace of one call and their count, and
    the host clock of another call without the profiler, both ending in a
    synchronize. Device ms is NaN where the trace shows no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return (busy / 1e3 if spans else float("nan")), wall, len(spans)


def llm_times(label: str, name: str, dtype: str, cfg, params, prompt, seed: int) -> dict:
    """(d) greedy stream == greedy batch, then (e) llm_bench's times with
    the default sampler and no end token, each beside its bound."""
    import torch

    from memex_tpu_torch.llm.local.model import SamplerConfig, decode_chunk, generate, prefill
    from memex_tpu_torch.llm.local.runtime import ByteTokenizer, LocalLLM

    dev = prompt.device
    P = prompt.shape[1]
    greedy = LocalLLM(cfg, params, ByteTokenizer(), SamplerConfig(temperature=0.0),
                      seed=seed, device=dev)
    toks, n_valid = generate(cfg, params, prompt, P, greedy.sampler, LLM_GREEDY_NEW,
                             greedy._gen, eos_id=ByteTokenizer.eos_id)
    batch = toks.tolist()[: int(n_valid)]
    streamed = greedy._stream(prompt, P, LLM_GREEDY_NEW, lambda s: None)
    check(streamed == batch, f"{name} {dtype}: greedy stream gave other tokens than generate")

    llm = LocalLLM(cfg, params, _NoEos(), SamplerConfig(), seed=seed, device=dev)
    prefill_ms = cuda_ms(lambda: prefill(cfg, params, prompt, P, llm.sampler), runs=10)

    def batch_once() -> float:
        t0 = time.perf_counter()
        out, _ = generate(cfg, params, prompt, P, llm.sampler, LLM_NEW, llm._gen, eos_id=-1)
        out.tolist()
        return time.perf_counter() - t0

    # Best of 3, as llm_bench.py (the greedy runs above warmed the path).
    batch_s = min(batch_once() for _ in range(3))
    st = stream_times(llm, prompt, LLM_NEW)
    # A decode step may not read the card back (it would stall the
    # lookahead): one chunk under CUDA's sync-debug mode raises if it does.
    carry = prefill(cfg, params, prompt, P, llm.sampler)
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_chunk(cfg, params, carry, llm.sampler, llm.STREAM_CHUNK, llm._gen, eos_id=-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    w_bytes, kv_bytes = step_bytes(cfg, params)
    bound_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    prefill_bound = max(w_bytes / HBM_BYTES_PER_S,
                        2 * matmul_params(params) * P / BF16_OPS_PER_S) * 1e3
    out = {
        "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound,
        "batch_tok_per_s": LLM_NEW / batch_s,
        "stream_tok_per_s": st["n"] / st["stream_s"],
        "first_token_ms": (st["prefill_s"] + st["first_s"]) * 1e3,
        "bound_ms_per_token": bound_ms, "bound_tok_per_s": 1e3 / bound_ms,
    }
    print(f"[{label}] phase6 {name} {dtype} greedy stream == generate ({len(batch)} tokens); "
          f"no read-back in a chunk (sync-debug); P={P} new={LLM_NEW} "
          f"prefill_ms={prefill_ms:.3f} (bound {prefill_bound:.3f}) "
          f"batch_tok_per_s={out['batch_tok_per_s']:.2f} "
          f"stream_tok_per_s={out['stream_tok_per_s']:.2f} "
          f"first_token_ms={out['first_token_ms']:.3f} bound_ms_per_token={bound_ms:.3f} "
          f"(weights {w_bytes / 1e9:.3f} GB + KV {kv_bytes / 1e9:.3f} GB a step at 3.35 TB/s; "
          f"{out['bound_tok_per_s']:.1f} tok/s)", flush=True)
    return out


def busy_share(label: str, name: str, dtype: str, cfg, params, prompt) -> None:
    """Device-busy share of one 16-token decode_chunk. Run after every
    timing of the phase: a torch.profiler session leaves later launches
    slower on the host for the rest of the process."""
    import torch

    from memex_tpu_torch.llm.local.model import SamplerConfig, decode_chunk, prefill

    sc = SamplerConfig()
    gen = torch.Generator(device=prompt.device).manual_seed(0)
    state = {"carry": prefill(cfg, params, prompt, prompt.shape[1], sc)}

    def chunk():
        state["carry"], _, _ = decode_chunk(cfg, params, state["carry"], sc, 16, gen,
                                            eos_id=-1)

    dev_ms, wall_ms, kernels = device_busy(chunk)
    print(f"[{label}] phase6 {name} {dtype} decode_chunk(16) wall_ms={wall_ms:.3f} "
          f"device_ms={dev_ms:.3f} busy_share={dev_ms / wall_ms:.3f} kernels={kernels} "
          f"({kernels / 16:.0f} a step; host us a kernel "
          f"{wall_ms * 1e3 / max(kernels, 1):.2f})", flush=True)


def phase6_model(label: str, seed: int, name: str, cfg, dtypes, device) -> tuple[dict, dict]:
    """One configuration: (a) card vs CPU, (c) each serving dtype vs
    float32, then for each dtype (b) cached decode vs prefill and (d)-(e).
    Returns {dtype: (params, prompt)} for the busy-share pass and {dtype:
    llm_times' readings}."""
    import dataclasses

    import torch

    from memex_tpu_torch.llm.local.model import convert_params, family_of

    t0 = time.perf_counter()
    params32 = family_of(cfg).init_params(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(3, cfg.vocab_size, (1, LLM_P), generator=gen, device=device)
    torch.cuda.synchronize()
    print(f"[{label}] phase6 {name} init float32 on the card seconds="
          f"{time.perf_counter() - t0:.3f} layers={cfg.num_layers} hidden={cfg.hidden_size} "
          f"heads={cfg.num_heads}/{cfg.num_kv_heads} ffn={cfg.intermediate_size} "
          f"vocab={cfg.vocab_size} context={cfg.max_context}", flush=True)
    card_vs_cpu(label, name, cfg, params32, prompt)
    full32 = prompt_logits(dataclasses.replace(cfg, compute_dtype="float32"), params32, prompt)
    served = {}
    for dtype in dtypes:
        params = convert_params(params32, dtype)
        full = prompt_logits(cfg, params, prompt)
        cos = min_cosine(full, full32)
        if dtype == "int8":
            steps = check_codes(params32, params)
            ref = prompt_logits(dataclasses.replace(cfg, compute_dtype="float32"), params,
                                prompt)
            cos_stored, cos_deq = min_cosine(full, ref), min_cosine(ref, full32)
            del ref
            # How the quantization noise grows with depth (printed only).
            depth = []
            for n in (1, cfg.num_layers // 2):
                cut = dataclasses.replace(cfg, num_layers=n)
                depth.append((n, min_cosine(
                    prompt_logits(cut, first_layers(params, n), prompt),
                    prompt_logits(dataclasses.replace(cut, compute_dtype="float32"),
                                  first_layers(params32, n), prompt))))
            print(f"[{label}] phase6 {name} int8 codes within half a step of their weights "
                  f"({steps} weights); vs the float32 model of its stored weights "
                  f"P={LLM_P} min_cosine={cos_stored:.5f} (bar {LLM_DTYPE_COS}); vs the "
                  f"float32 model min_cosine={cos:.5f} (the float32 model of the stored "
                  f"weights vs the float32 model {cos_deq:.5f}; int8 vs float32 after "
                  + ", ".join(f"{n} layers {c:.5f}" for n, c in depth) + ")", flush=True)
            cos = cos_stored
        else:
            print(f"[{label}] phase6 {name} {dtype} vs float32 on the card P={LLM_P} "
                  f"min_cosine={cos:.5f} (bar {LLM_DTYPE_COS})", flush=True)
        check(cos >= LLM_DTYPE_COS, f"{name} {dtype} logits: cosine {cos:.5f}")
        served[dtype] = (params, full)
    del params32, full32, params, full
    torch.cuda.empty_cache()
    times = {}
    for dtype in dtypes:
        params, full = served[dtype]
        cos = decode_vs_prefill(cfg, params, prompt, full)
        print(f"[{label}] phase6 {name} {dtype} prefill {LLM_P - LLM_CHECK_STEPS} + "
              f"{LLM_CHECK_STEPS} cached decode steps vs one prefill of {LLM_P}: "
              f"min_cosine={cos:.5f} (bar {LLM_DECODE_COS})", flush=True)
        check(cos >= LLM_DECODE_COS, f"{name} {dtype}: cached decode cosine {cos:.5f}")
        times[dtype] = llm_times(label, name, dtype, cfg, params, prompt, seed)
        served[dtype] = (params, prompt)
        del params, full
        torch.cuda.empty_cache()
    return served, times


def write_llama_checkpoint(model_dir: str, cfg, seed: int, device: str) -> None:
    """An HF-format llama checkpoint of `cfg` (float16 safetensors and a
    config.json) from init_params' seeded weights."""
    import torch
    from safetensors.numpy import save_file

    from memex_tpu_torch.llm.local.model import _HF, init_params

    params = init_params(cfg, seed=seed, device=device)

    def host(t):
        return t.to(torch.float16).contiguous().cpu().numpy()

    tensors = {"model.embed_tokens.weight": host(params["embed"]),
               "model.norm.weight": host(params["final_norm"]),
               "lm_head.weight": host(params["lm_head"].T)}
    for ours, (hf, transpose) in _HF.items():
        for i, w in enumerate(params["layers"][ours]):
            tensors[f"model.layers.{i}.{hf}"] = host(w.T if transpose else w)
    os.makedirs(model_dir, exist_ok=True)
    save_file(tensors, os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "config.json"), "w") as fh:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_context, "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.rms_eps}, fh)


def http_error(method: str, url: str, body: dict, timeout: float) -> tuple[int, dict]:
    try:
        return 200, http(method, url, body, timeout=timeout)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def phase6_http(label: str, seed: int, work: str, device: str = "cuda") -> None:
    """The server with LOCAL_LLM_CONFIG on a TinyLlama-1.1B-geometry HF
    checkpoint (bf16 weights on the card): two concurrent asks and a
    Summarize task run by the worker. A random-weight answer is mostly
    not JSON (the route's 400 "LLM response was not valid JSON"), but a
    few sampled bytes can be (a lone digit came back once): either reply
    shows the model ran to the end."""
    import torch

    cfg = llm_models()[0][1]
    ckpt = os.path.join(work, "tinyllama")
    t0 = time.perf_counter()
    write_llama_checkpoint(ckpt, cfg, seed, device)
    torch.cuda.empty_cache()
    size = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
    print(f"[{label}] phase6 http TinyLlama-1.1B float16 checkpoint bytes={size} "
          f"seconds={time.perf_counter() - t0:.3f}", flush=True)
    toml = os.path.join(work, "llm.toml")
    with open(toml, "w") as fh:
        fh.write(f'[model]\npath = "{ckpt}"\nname = "tinyllama-1.1b-random"\n'
                 'param_dtype = "bfloat16"\n')
    model_dir = os.path.join(work, "model")
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    env = {k: v for k, v in os.environ.items() if k not in ("MEMEX_FAKE_LLM", "OPENAI_API_KEY")}
    env.update(EMBEDDING_MODEL=model_dir, LOCAL_LLM_CONFIG=toml,
               DATABASE_CONNECTION=f"sqlite://{work}/llm.db",
               VECTOR_CONNECTION=f"tpu://{work}/vectors_llm")
    with port_server(work, "llm", env, device) as base:
        text = " ".join(make_docs(random.Random(seed), 3))

        def ask(i: int) -> tuple[float, int, dict]:
            t = time.perf_counter()
            status, body = http_error("POST", f"{base}/api/action/ask",
                                      {"text": text, "query": f"question {i}?"}, timeout=900)
            return time.perf_counter() - t, status, body

        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            asks = list(pool.map(ask, range(2)))
        kinds = []
        for secs, status, body in asks:
            if status == 200 and "jsonResponse" in body.get("result", {}):
                kinds.append("200 jsonResponse")
            else:
                check(status == 400 and "LLM response was not valid JSON" in json.dumps(body),
                      f"ask gave {status} {json.dumps(body)[:200]}")
                kinds.append("400 not valid JSON")
        print(f"[{label}] phase6 http two concurrent asks: {kinds}; seconds per request "
              f"{[round(a[0], 3) for a in asks]} (the model loads in the first) "
              f"wall={time.perf_counter() - t0:.3f}", flush=True)
        t0 = time.perf_counter()
        tid = http("POST", f"{base}/api/action/summarize/task", {"text": text})["result"]["taskId"]
        while True:
            res = http("GET", f"{base}/api/tasks/{tid}")["result"]
            check(res["status"] != "Failed", f"summarize task failed: {res}")
            if res["status"] == "Completed":
                break
            check(time.perf_counter() - t0 < 900, "summarize task unfinished after 900s")
            time.sleep(0.1)
        out = res.get("result")
        out = json.loads(out) if isinstance(out, str) else out
        check(isinstance(out, dict) and isinstance(out.get("summary"), str),
              f"summarize task result {out!r}")
        print(f"[{label}] phase6 http summarize task Completed seconds="
              f"{time.perf_counter() - t0:.3f} summary_chars={len(out['summary'])}", flush=True)


def phase6(label: str, seed: int, work: str) -> dict:
    """The local LLM on the card: each configuration in process, then the
    HTTP server with LOCAL_LLM_CONFIG. Returns TinyLlama-1.1B bf16's
    llm_times readings (phase 10 prints llm_bench's beside them)."""
    import torch

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    print(f"[{label}] phase6 start allocated_gb={torch.cuda.memory_allocated() / 1e9:.3f}",
          flush=True)
    models, times = [], {}
    for name, cfg, dtypes in llm_models():
        served, times[name] = phase6_model(label, seed, name, cfg, dtypes, dev)
        models += [(name, dtype, cfg, *served[dtype]) for dtype in dtypes]
        del served
        torch.cuda.empty_cache()
    # The served models (35 GB in all) stay on the card for this pass.
    for model in models:
        busy_share(label, *model)
    del models, model
    torch.cuda.empty_cache()
    phase6_http(label, seed, work)
    return times["TinyLlama-1.1B"]["bfloat16"]


# -- phase 7 -------------------------------------------------------------------
# Encoder fine-tuning (memex_tpu_torch/train/) at all-MiniLM-L12-v2 width on
# phase 2's seeded random checkpoint: the CLI's load and train (checkpoint,
# resume, HF export), the step in process (card vs CPU, repeat runs, two
# entries of the card, a falling loss), its time beside its bound, then the
# server on the exported encoder. The fallback vocab is character-level, so
# a document of ~520 words is ~2,600 tokens: 15 windows of 254 at stride 86.
TRAIN_DOCS = 96
TRAIN_WORDS = 520
TRAIN_B, TRAIN_L = 32, 64   # the CLI's batch and train_encoder's max_len
TRAIN_CUT_LAYERS = 2        # the card-vs-CPU copy, as phase 6
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores (TF32 off)
# Card vs CPU and one entry vs two: both sides run the step in float32 and
# sum the same products in other orders (a few ulps). The loss is held
# absolutely; the gradient, through Adam's first moment (mu = 0.1 x the
# clipped gradient), relative to its largest entry; the params within
# 2.5 lr, since Adam's first update moves each coordinate by at most lr
# whatever its gradient (a coordinate whose gradient is rounding noise on
# both sides, such as the attention key bias, may move either way).
TRAIN_LOSS_TOL = 1e-4
TRAIN_SPLIT_LOSS_TOL = 1e-5
TRAIN_MU_REL_TOL = 1e-3


def train_docs(rng: random.Random, n: int, words: int) -> list[str]:
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = ["".join(rng.choice(letters) for _ in range(rng.randint(3, 7)))
             for _ in range(5000)]
    return [" ".join([f"doc{i}"] + [rng.choice(vocab) for _ in range(words)])
            for i in range(n)]


def run_cli(label: str, args: list[str], env: dict, cwd: str,
            timeout: float) -> subprocess.CompletedProcess:
    """`python -m memex_tpu_torch <args>`. Fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "memex_tpu_torch", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:] + "\n")
    check(proc.returncode == 0, f"`{' '.join(args)}` exited with {proc.returncode}")
    print(f"[{label}] phase7 cli `{' '.join(args)}` seconds={time.perf_counter() - t0:.3f}",
          flush=True)
    return proc


def train_metrics(proc: subprocess.CompletedProcess) -> dict:
    """train's metrics line, and `epoch_s`: its one epoch's seconds, from
    its log (a fresh process: the first step's allocations included)."""
    import re

    lines = proc.stdout.strip().splitlines()
    check(bool(lines), "train printed nothing")
    m = json.loads(lines[-1])
    for key in ("loss", "accuracy", "pairs", "step"):
        check(key in m, f"train's metrics lack {key}: {m}")
    check(m["loss"] == m["loss"] and abs(m["loss"]) < 1e6, f"train's loss {m['loss']}")
    epochs = re.findall(r"epoch 0: loss \S+ acc \S+ \(([0-9.]+)s\)", proc.stderr)
    check(len(epochs) == 1, "train logged no epoch time")
    return m | {"epoch_s": float(epochs[0])}


def train_bound(cfg, rows: int, length: int, n_params: int) -> tuple[float, float, float]:
    """(bound ms, operations, bytes) of one step on `rows` pairs of `length`
    tokens: each dense weight does 2 flops a token forward and 4 backward;
    the attention products (QK^T and PV, 4 L^2 H a sequence and layer)
    three times over, and the [B, B] logits likewise; the optimizer reads
    params, grads, mu and nu and writes three of them back."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    dense = cfg.num_layers * (4 * H * H + 2 * H * I)
    seqs = 2 * rows
    ops = 6 * dense * seqs * length + 3 * 4 * length * length * H * cfg.num_layers * seqs
    ops += 3 * 2 * rows * rows * H
    n_bytes = 7 * 4 * n_params
    return max(ops / F32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3, ops, n_bytes


def step_diff(a, b) -> tuple[float, float, float]:
    """(largest param difference, largest mu difference, largest |mu|)."""
    dp = max(float((x.detach().cpu() - y.detach().cpu()).abs().max())
             for x, y in zip(a["params"].parameters(), b["params"].parameters()))
    mu_a, mu_b = a["opt"].moments("mu"), b["opt"].moments("mu")
    dm = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(mu_a, mu_b))
    top = max(float(x.abs().max()) for x in mu_a)
    return dp, dm, top


def top_kernels(fn, n: int = 8) -> list[tuple[str, float, int]]:
    """The n kernels with the most device time in a torch.profiler trace of
    one call of fn(): (name, ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in device_events(prof):
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(name, ms, count) for name, (ms, count) in ranked]


def phase7_in_process(label: str, seed: int, work: str, db_path: str) -> None:
    """(a) card vs CPU, (b) repeat runs, (c) two entries, (d) a falling
    loss, (e) the step's time and busy share, on one batch of the
    collection's pairs at full width."""
    import dataclasses
    import types

    import numpy as np
    import torch

    from memex_tpu_torch.config import Settings
    from memex_tpu_torch.models.minilm import load_params
    from memex_tpu_torch.runtime import TorchRuntime
    from memex_tpu_torch.text.tokenizer import WordPieceTokenizer
    from memex_tpu_torch.train import TrainConfig, init_train_state, make_train_step
    from memex_tpu_torch.train.loop import _tokenize_pairs, pairs_from_sql

    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 matmuls")
    model_dir = os.path.join(work, "model")
    rt = TorchRuntime(Settings(db_uri=f"sqlite://{db_path}", embedding_model=model_dir),
                      device=dev)
    tok = WordPieceTokenizer.from_pretrained_dir(model_dir)
    pairs = pairs_from_sql(rt, "traincol")
    sel = np.random.default_rng(seed).permutation(len(pairs))[:TRAIN_B]
    ids = _tokenize_pairs(types.SimpleNamespace(tokenizer=tok), [pairs[i] for i in sel], TRAIN_L)
    batch = dict(zip(("q_ids", "q_mask", "d_ids", "d_mask"), ids))
    cfg, host_model = load_params(model_dir)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    sd = host_model.state_dict()
    tc = TrainConfig()

    def state_on(device, cut=None, train_cfg=tc):
        c = cfg if cut is None else dataclasses.replace(cfg, num_layers=cut)
        keep = {k: v for k, v in sd.items()
                if cut is None or not k.startswith("layers.") or int(k.split(".")[1]) < cut}
        return c, init_train_state(c, keep, train_cfg, device=device)

    # (a) card vs CPU, two layers at full width, one step.
    cut_cfg, cpu_state = state_on("cpu", TRAIN_CUT_LAYERS)
    _, card_state = state_on(dev, TRAIN_CUT_LAYERS)
    _, m_cpu = make_train_step(cut_cfg, tc)(cpu_state, batch)
    _, m_card = make_train_step(cut_cfg, tc)(card_state, batch)
    dl = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    dp, dm, top = step_diff(card_state, cpu_state)
    print(f"[{label}] phase7 {TRAIN_CUT_LAYERS}-layer full-width step card vs cpu "
          f"B={TRAIN_B} L={TRAIN_L}: loss {float(m_card['loss']):.6f} vs "
          f"{float(m_cpu['loss']):.6f} diff={dl:.3e} (tol {TRAIN_LOSS_TOL}); max mu diff="
          f"{dm:.3e} of max |mu| {top:.3e} (rel tol {TRAIN_MU_REL_TOL}); max param diff="
          f"{dp:.3e} (tol {2.5 * tc.learning_rate:.1e})", flush=True)
    check(dl <= TRAIN_LOSS_TOL, f"card vs cpu loss diff {dl}")
    check(dm <= TRAIN_MU_REL_TOL * top, f"card vs cpu mu diff {dm} of {top}")
    check(dp <= 2.5 * tc.learning_rate, f"card vs cpu param diff {dp}")
    del cpu_state, card_state

    # (b) two runs from one seed, two steps each: bit-equal.
    runs = []
    for _ in range(2):
        _, st = state_on(dev)
        step = make_train_step(cfg, tc)
        losses = [float(step(st, batch)[1]["loss"]) for _ in range(2)]
        runs.append((st, losses))
    (a, la), (b, lb) = runs
    same = la == lb and all(torch.equal(x, y) for x, y in
                            zip(a["params"].parameters(), b["params"].parameters()))
    same = same and all(torch.equal(x, y) for key in ("mu", "nu")
                        for x, y in zip(a["opt"].moments(key), b["opt"].moments(key)))
    print(f"[{label}] phase7 full-width two runs of two steps from one seed: bit-equal "
          f"params, mu and nu = {same} (losses {la})", flush=True)
    check(same, "two training runs from one seed differ")
    del runs, a, b, st

    # (c) the step over two entries of the card against one entry.
    _, one = state_on(dev)
    _, two = state_on(dev)
    _, m1 = make_train_step(cfg, tc)(one, batch)
    _, m2 = make_train_step(cfg, tc, [dev, dev])(two, batch)
    dl = abs(float(m1["loss"]) - float(m2["loss"]))
    dp, dm, top = step_diff(two, one)
    print(f"[{label}] phase7 full-width step over [cuda:0, cuda:0] vs [cuda:0]: loss diff="
          f"{dl:.3e} (tol {TRAIN_SPLIT_LOSS_TOL}); max mu diff={dm:.3e} of {top:.3e}; "
          f"max param diff={dp:.3e}", flush=True)
    check(dl <= TRAIN_SPLIT_LOSS_TOL, f"two-entry loss diff {dl}")
    check(dm <= TRAIN_MU_REL_TOL * top, f"two-entry mu diff {dm} of {top}")
    check(dp <= 2.5 * tc.learning_rate, f"two-entry param diff {dp}")
    del one, two

    # (d) the loss on one repeated batch falls over 10 steps.
    fall_tc = TrainConfig(learning_rate=1e-4)
    _, st = state_on(dev, train_cfg=fall_tc)
    step = make_train_step(cfg, fall_tc)
    losses = [float(step(st, batch)[1]["loss"]) for _ in range(11)]
    print(f"[{label}] phase7 one batch, lr 1e-4, 11 steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}", flush=True)
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    del st

    # (e) step time at full width, TF32 off, after warmup; busy share last.
    _, st = state_on(dev)
    step = make_train_step(cfg, tc)
    n_params = sum(p.numel() for p in st["params"].parameters())
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(st, batch), runs=20, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    bound, ops, n_bytes = train_bound(cfg, TRAIN_B, TRAIN_L, n_params)
    dev_ms, wall_ms, kernels = device_busy(lambda: step(st, batch))
    print(f"[{label}] phase7 train step B={TRAIN_B} L={TRAIN_L} layers={cfg.num_layers} "
          f"float32 (TF32 off) step_ms={ms:.3f} pairs_per_s={TRAIN_B / ms * 1e3:.1f} "
          f"bound_ms={bound:.3f} (operations {ops:.3e} at 67 TFLOP/s; bytes {n_bytes:.3e} "
          f"at 3.35 TB/s; params {n_params}) share_of_bound={bound / ms:.3f} "
          f"bound_pairs_per_s={TRAIN_B / bound * 1e3:.1f} peak_allocated_gb={peak:.3f}; "
          f"profiled step wall_ms={wall_ms:.3f} device_ms={dev_ms:.3f} "
          f"busy_share={dev_ms / wall_ms:.3f} kernels={kernels}", flush=True)
    for name, k_ms, count in top_kernels(lambda: step(st, batch)):
        print(f"[{label}] phase7 train step kernel ms={k_ms:.3f} launches={count} "
              f"{name[:110]}", flush=True)
    del st
    torch.cuda.empty_cache()


def phase7(label: str, seed: int, work: str) -> int:
    """Encoder fine-tuning through the CLI and in process, then the server
    on the exported encoder; returns the K1 launches of its searches."""
    import sqlite3

    model_dir = os.path.join(work, "model")
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    docs_dir = os.path.join(work, "train_docs")
    os.makedirs(docs_dir)
    for i, doc in enumerate(train_docs(random.Random(seed), TRAIN_DOCS, TRAIN_WORDS)):
        with open(os.path.join(docs_dir, f"{i:03d}.txt"), "w") as fh:
            fh.write(doc)
    db_path = os.path.join(work, "train.db")
    env = dict(os.environ, EMBEDDING_MODEL=model_dir, DATABASE_CONNECTION=f"sqlite://{db_path}",
               VECTOR_CONNECTION=f"tpu://{work}/vectors_train",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    run_cli(label, ["load", "traincol", docs_dir, "--wait", "--timeout", "300"], env, work, 400)
    with sqlite3.connect(db_path) as conn:
        windows, n_docs = conn.execute(
            "SELECT COUNT(*), COUNT(DISTINCT document_id) FROM embeddings "
            "WHERE collection = 'traincol'").fetchone()
    check(n_docs == TRAIN_DOCS, f"{n_docs} of {TRAIN_DOCS} documents ingested")
    print(f"[{label}] phase7 load: docs={n_docs} windows={windows} "
          f"adjacent pairs={windows - n_docs}", flush=True)

    ft, ckpt = os.path.join(work, "ft"), os.path.join(work, "st.npz")
    m1 = train_metrics(run_cli(label, ["train", "traincol", "--out", ft, "--checkpoint", ckpt],
                               env, work, 300))
    check(m1["pairs"] == windows - n_docs, f"train saw {m1['pairs']} pairs")
    check(m1["step"] == m1["pairs"] // TRAIN_B, f"train took {m1['step']} steps")
    for name in ("model.safetensors", "config.json", "vocab.txt"):
        check(os.path.exists(os.path.join(ft, name)), f"the export lacks {name}")
    m2 = train_metrics(run_cli(label, ["train", "traincol", "--resume", ckpt], env, work, 300))
    check(m2["step"] == 2 * m1["step"], f"resume went from step {m1['step']} to {m2['step']}")
    print(f"[{label}] phase7 train metrics {json.dumps(m1)}; resumed {json.dumps(m2)}; "
          f"the epoch's pairs_per_s={m1['step'] * TRAIN_B / m1['epoch_s']:.1f} / "
          f"{m2['step'] // 2 * TRAIN_B / m2['epoch_s']:.1f}", flush=True)

    phase7_in_process(label, seed, work, db_path)
    return phase2(label, seed, work, "vectors_ft", "fused_topk", n_docs=50, model="ft",
                  clients=8, tag="phase7 http (fine-tuned encoder)")


# -- phase 8 -------------------------------------------------------------------
# Multi-host bring-up (parallel/distributed.py): two ranks, spawned here, each
# a controller of one shard on the one card, joined over gloo
# (MEMEX_DIST_BACKEND=gloo: NCCL refuses two ranks on one device). Each rank
# generates the same rows from the seed, searches its own shard and
# all_gathers the candidates; rank 0 also runs the single controller over two
# shards of the card on the same rows, and the hits must be identical.
RANKS = 2
RANK_TIMEOUT_S = 600
IVF_1M_SHARDED = dict(n_clusters=IVF_1M_CLUSTERS, nprobe=64, bucket_factor=1.2)
SERVE_DOCS, SERVE_SEARCHES = 50, 16


def _wire_hits(hits) -> list:
    return [[[sid if isinstance(sid, str) else int(sid), float(v)] for sid, v in h]
            for h in hits]


def phase8_rank(rank: int, coordinator: str, work: str, seed: int) -> None:
    """One rank of phase 8 (`chip_smoke.py --phase8-rank R`): the flat tiers
    of K1-K4 and the 1M-row sharded IVF (K5) over the process group, each
    search's launches, its shard's bank against its plain version, search
    times (rank 0 beside the single controller) and the all_gather's; all
    into {work}/phase8_rank{R}.json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from memex_tpu_torch.index.sharded import ShardedFlatIndex
    from memex_tpu_torch.index.sharded_ivf import ShardedIVFIndex
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.parallel import init_multihost
    from memex_tpu_torch.parallel.collectives import gather_candidates

    label = f"phase8 rank {rank}"
    check(init_multihost(coordinator, RANKS, rank, device="cuda"), "init_multihost declined")
    group = dist.group.WORLD
    check(dist.get_backend(group) == "gloo", f"backend {dist.get_backend(group)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out: dict = {"flat": {}, "errs": {}}

    # The rows of phase 3's shape, made on the card from the seed alike on
    # both ranks.
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    base = unit_rows(N_ROWS, DIM, gen, dev)
    src = torch.randperm(N_ROWS, generator=gen, device=dev)[:128]
    q = base[src] + 0.05 / DIM ** 0.5 * torch.randn((128, DIM), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    oracle = torch.sort(q @ base.T, dim=1, descending=True, stable=True).indices[:, :10].cpu()
    base_np, q_np, src = base.cpu().numpy(), q.cpu().numpy(), src.cpu().numpy()
    ids = [f"r{i}" for i in range(N_ROWS)]
    del base
    torch.cuda.empty_cache()
    for name, opts, kernel, bar in (t for t in TIERS if t[0] in SHARDED_TIERS):
        index = ShardedFlatIndex(DIM, [dev], capacity_per_shard=N_ROWS // RANKS, group=group,
                                 **opts)
        index.add(base_np, ids)
        ft.reset_launches()
        hits = index.search(q_np, 10)
        launched = dict(ft.LAUNCHES)
        res = {"hits": _wire_hits(hits), "launches": launched, "kernel": kernel, "bar": bar,
               "recall": float(np.mean([len({x for x, _ in h} & {f"r{int(j)}" for j in o}) / 10
                                        for h, o in zip(hits, oracle)])),
               "top1": float(np.mean([h[0][0] == f"r{s}" for h, s in zip(hits, src)]))}
        out["errs"][kernel] = max(out["errs"].get(kernel, 0.0), shard_bank_check(
            label, name, kernel, index, q[:MAIN_Q], index.own[0], tag="phase8"))
        res["ms"] = {Q: search_ms(index, q_np[:Q]) for Q in TIMED_Q}
        del index
        torch.cuda.empty_cache()
        if rank == 0:
            one = ShardedFlatIndex(DIM, [dev] * RANKS, capacity_per_shard=N_ROWS // RANKS,
                                   **opts)
            one.add(base_np, ids)
            res["single_hits"] = _wire_hits(one.search(q_np, 10))
            res["single_ms"] = {Q: search_ms(one, q_np[:Q]) for Q in TIMED_Q}
            del one
            torch.cuda.empty_cache()
        out["flat"][name] = res
        print(f"[{label}] phase8 {name} done", flush=True)
    del base_np

    # The all_gather of the merge's [Q, kk] candidates (kk = 40 at k = 10):
    # values and global rows in one exchange, through the host on gloo.
    out["gather_ms"] = {}
    for Q in TIMED_Q:
        vals = torch.zeros((Q, 40), device=dev)
        rows = torch.zeros((Q, 40), dtype=torch.int64, device=dev)
        times = []
        for i in range(21):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gather_candidates(vals, rows, group)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t) * 1e3)
        out["gather_ms"][Q] = statistics.median(times)

    # The 1M-row IVF configuration of phase 4, int8, its clusters over the ranks.
    centres = unit_rows(IVF_CENTRES, DIM, gen, dev)
    base = clustered_rows(N_ROWS, centres, gen)
    q1 = clustered_rows(128, centres, gen)
    oracle1 = oracle_topk(q1, base)
    base_np, q1_np = base.cpu().numpy(), q1.cpu().numpy()
    del base
    torch.cuda.empty_cache()
    ids = list(range(N_ROWS))
    t0 = time.perf_counter()
    index = ShardedIVFIndex(DIM, [dev], group=group, **IVF_1M_SHARDED)
    index.build(base_np, ids)
    torch.cuda.synchronize()
    res = {"build_s": time.perf_counter() - t0, "C": index.C, "M": index.M,
           "spill": index.spill.count}
    ft.reset_launches()
    hits = index.search(q1_np, IVF_K)
    res.update(hits=_wire_hits(hits), launches=dict(ft.LAUNCHES),
               recall=recall_at_k(hits, oracle1))
    out["errs"]["ivf_batch"] = ivf_shard_bank_check(label, "phase8 1M", index,
                                                    q1[:MAIN_Q].contiguous(), index.own[0])
    res["ms"] = {Q: search_ms(index, q1_np[:Q]) for Q in TIMED_Q}
    res["centroids"] = hashlib.sha256(index.centroids.cpu().numpy().tobytes()).hexdigest()
    del index
    torch.cuda.empty_cache()
    if rank == 0:
        one = ShardedIVFIndex(DIM, [dev] * RANKS, **IVF_1M_SHARDED)
        one.build(base_np, ids)
        res["single_hits"] = _wire_hits(one.search(q1_np, IVF_K))
        res["single_ms"] = {Q: search_ms(one, q1_np[:Q]) for Q in TIMED_Q}
        del one
    out["ivf"] = res
    with open(os.path.join(work, f"phase8_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(argv: list[str], env: dict, log_path: str, cwd: str):
    with open(log_path, "w") as log:
        return subprocess.Popen(argv, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)


def _reap(procs, logs, timeout: float, what: str) -> None:
    """Wait for every process; on a failure or past the timeout, kill all,
    print the logs' tails, and fail."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        check(not bad, f"{what}: rank(s) {bad} exited with "
                       f"{[procs[i].returncode for i in bad]}")
    except BaseException as exc:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for i, path in enumerate(logs):
            with open(path) as fh:
                sys.stderr.write(f"{what} rank {i} log tail:\n{fh.read()[-3000:]}\n")
        if isinstance(exc, subprocess.TimeoutExpired):
            raise SmokeFailure(f"{what}: a rank ran past {timeout:.0f}s") from exc
        raise


def phase8_http(label: str, seed: int, work: str) -> int:
    """`python -m memex_tpu_torch serve --device cuda` on two ranks over
    gloo (MEMEX_COORDINATOR, a `tpu+mesh://` float32 store and a SQLite file
    each), at full all-MiniLM-L12-v2 width: each document posted to both
    and completed on both before the next, then each search sent to both at
    once. Both must answer with the same hits, each launching K1 once a
    search; both must shut down cleanly, each with its own copy of the same
    checkpoint. Returns the K1 launches."""
    model_dir = os.path.join(work, "model")
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    coord, ports = f"127.0.0.1:{free_port()}", [free_port() for _ in range(RANKS)]
    bases = [f"http://127.0.0.1:{p}" for p in ports]
    procs, logs = [], []
    for r in range(RANKS):
        env = dict(os.environ, EMBEDDING_MODEL=model_dir, MEMEX_FAKE_LLM="1",
                   MEMEX_COORDINATOR=coord, MEMEX_NUM_PROCESSES=str(RANKS),
                   MEMEX_PROCESS_ID=str(r), MEMEX_DIST_BACKEND="gloo",
                   DATABASE_CONNECTION=f"sqlite://{work}/p8_rank{r}.db",
                   VECTOR_CONNECTION=f"tpu+mesh://{work}/vectors_p8_rank{r}",
                   HOST="127.0.0.1", PORT=str(ports[r]),
                   PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                              if p))
        logs.append(os.path.join(work, f"server_p8_rank{r}.log"))
        procs.append(_spawn([sys.executable, "-m", "memex_tpu_torch", "serve", "--roles",
                             "Api,Worker", "--device", "cuda"], env, logs[-1], work))
    try:
        deadline = time.monotonic() + 300
        for base in bases:
            while True:
                check(all(p.poll() is None for p in procs), "a serving rank exited")
                try:
                    http("GET", f"{base}/api/health", timeout=5)
                    break
                except OSError:
                    check(time.monotonic() < deadline, "the ranks did not come up in 300s")
                    time.sleep(0.5)
        docs = make_docs(random.Random(seed + 8), SERVE_DOCS)
        t0 = time.perf_counter()
        for doc in docs:
            tasks = [http("POST", f"{b}/api/collections/smoke", {"content": doc})["result"]
                     ["taskId"] for b in bases]
            for b, tid in zip(bases, tasks):
                while True:
                    status = http("GET", f"{b}/api/tasks/{tid}")["result"]["status"]
                    check(status != "Failed", f"ingest task {tid} failed on {b}")
                    if status == "Completed":
                        break
                    check(time.perf_counter() - t0 < 600, "lockstep ingest past 600s")
                    time.sleep(0.02)
        ingest_s = time.perf_counter() - t0
        before = [_launches(b, "fused_topk") for b in bases]
        rng = random.Random(seed + 9)
        picks = [rng.randrange(len(docs)) for _ in range(SERVE_SEARCHES)]
        lat = []
        with ThreadPoolExecutor(RANKS) as pool:
            for i in picks:
                t = time.perf_counter()
                answers = list(pool.map(lambda b, d=docs[i]: http(
                    "POST", f"{b}/api/collections/smoke/search", {"query": d, "limit": 10}),
                    bases))
                lat.append((time.perf_counter() - t) * 1e3)
                hits = [a["result"]["results"] for a in answers]
                check(all(h == hits[0] for h in hits), f"the ranks differ on doc {i}")
                check(len(hits[0]) == 10 and hits[0][0]["content"] == docs[i],
                      f"doc {i}'s own text ranked {hits[0][0]['content'][:40]!r} first")
        launched = [_launches(b, "fused_topk") - n for b, n in zip(bases, before)]
        check(launched == [SERVE_SEARCHES] * RANKS,
              f"K1 launches per rank {launched}, not {SERVE_SEARCHES} each")
        lat.sort()
        print(f"[{label}] phase8 http two ranks: ingest docs={len(docs)} lockstep seconds="
              f"{ingest_s:.3f}; searches={len(picks)} identical on both ranks, p50_ms="
              f"{lat[len(lat) // 2]:.3f} max_ms={lat[-1]:.3f}; K1 launches per rank "
              f"{launched}", flush=True)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        for r, path in enumerate(logs):
            with open(path) as fh:
                sys.stderr.write(f"phase8 http rank {r} log tail:\n{fh.read()[-3000:]}\n")
        raise
    for p in procs:
        p.send_signal(signal.SIGTERM)
    _reap(procs, logs, 120, "phase8 http")  # both must exit 0
    metas = []
    for r in range(RANKS):  # each rank wrote its own copy of the same checkpoint
        with open(os.path.join(work, f"vectors_p8_rank{r}", "smoke.mesh.meta.json")) as fh:
            metas.append(fh.read())
    check(all(m == metas[0] for m in metas), "the ranks wrote different checkpoints")
    return sum(launched)


def phase8(label: str, seed: int, work: str) -> tuple[dict, dict]:
    """Two ranks on the card (see phase8_rank), then two ranks of the server.
    Returns (each kernel's launches on this path, its worst bank error)."""
    import torch

    from memex_tpu_torch.ops import fused_topk as ft

    torch.cuda.empty_cache()
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, MEMEX_DIST_BACKEND="gloo",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("MEMEX_COORDINATOR", None)
    t0 = time.perf_counter()
    logs = [os.path.join(work, f"phase8_rank{r}.log") for r in range(RANKS)]
    procs = [_spawn([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                     "--phase8-rank", str(r), "--coordinator", coord, "--work", work],
                    env, logs[r], work) for r in range(RANKS)]
    _reap(procs, logs, RANK_TIMEOUT_S, "phase8")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(work, f"phase8_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    print(f"[{label}] phase8 two ranks over gloo on one card: seconds="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    launches = dict.fromkeys(ft.LAUNCHES, 0)
    errs: dict[str, float] = {}
    for r, res in enumerate(ranks):
        for kernel, err in res["errs"].items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    for name in [t[0] for t in TIERS if t[0] in SHARDED_TIERS] + ["ivf"]:
        per = [res["ivf"] if name == "ivf" else res["flat"][name] for res in ranks]
        lead = per[0]
        kernel = "ivf_batch" if name == "ivf" else lead["kernel"]
        bar = 0.93 if name == "ivf" else lead["bar"]
        n = [p["launches"][kernel] for p in per]
        check(n == [1] * RANKS, f"phase8 {name}: {kernel} launches per rank {n}, not 1 each")
        for p in per:
            launches[kernel] += p["launches"][kernel]
            if name == "ivf":
                launches["fused_topk_int8q"] += p["launches"]["fused_topk_int8q"]  # the spill
        check(all(p["hits"] == lead["hits"] for p in per), f"phase8 {name}: the ranks differ")
        check(lead["hits"] == lead["single_hits"],
              f"phase8 {name}: two ranks differ from the single controller")
        if name == "ivf":
            check(all(p["centroids"] == lead["centroids"] for p in per),
                  "phase8 ivf: the ranks hold different centroids")
        check(lead["recall"] >= bar, f"phase8 {name}: recall@10 {lead['recall']:.4f} < {bar}")
        if name != "ivf":
            check(lead["top1"] >= 0.99, f"phase8 {name}: source row first {lead['top1']:.4f}")
        extra = (f"build_seconds={lead['build_s']:.3f} C={lead['C']} M={lead['M']} "
                 f"spill_rows={lead['spill']} " if name == "ivf" else "")
        print(f"[{label}] phase8 {name} Q=128 {kernel}_launches_per_rank={n} {extra}"
              f"recall_at_10_vs_f32_oracle={lead['recall']:.4f} (bar {bar}) hits identical "
              f"across ranks and to the single controller over {RANKS} shards", flush=True)
        for Q in map(str, TIMED_Q):  # JSON keys
            ms = " / ".join(f"{p['ms'][Q]:.3f}" for p in per)
            print(f"[{label}] phase8 {name} search Q={Q} median_ms two_ranks={ms} "
                  f"single_controller={lead['single_ms'][Q]:.3f}", flush=True)
    for Q in map(str, TIMED_Q):
        ms = " / ".join(f"{res['gather_ms'][Q]:.3f}" for res in ranks)
        print(f"[{label}] phase8 all_gather of [Q, 40] float32 + int64 (one int32 exchange) "
              f"over gloo Q={Q} "
              f"median_ms={ms}", flush=True)
    launches["fused_topk"] += phase8_http(label, seed, work)
    return launches, errs


# -- phase 9 -------------------------------------------------------------------

# Ingest at all-MiniLM-L12-v2 width as the service runs it (bf16 compute,
# L = 256, max_batch = 512): 16,384 windows, 32 super-chunks of the bulk path.
INGEST_N = 16384
INGEST_BATCH = 512
FETCH_DTYPES = ("float32", "float16", "bfloat16")
DP_N = 1000  # no multiple of the 512-row bucket
# Data-parallel against one device, bf16 compute: each block runs its rows
# in a GEMM of another shape, which may sum in another order; one flipped
# bf16 rounding of a hidden state moves a unit vector's entries by ~1e-3.
DP_TOL = 2e-3
BF16_PEAK = 989e12  # dense bf16 tensor-core operations a second (H100 SXM)
RERANK_TOL = 1e-5


def encoder_flop_per_window(cfg, length: int) -> int:
    """The encoder's matmul operations for one window, as bench.py:1315-1322
    counts them: per token, 12 layers of Q/K/V/output projections (4 D^2
    multiply-adds) and the FFN (2 D I), plus the attention products (2 L D
    a layer), 2 operations a multiply-add; every position of the window
    runs, padding included."""
    per_tok = (2 * cfg.num_layers * (4 * cfg.hidden_size ** 2
                                     + 2 * cfg.hidden_size * cfg.intermediate_size)
               + 4 * cfg.num_layers * length * cfg.hidden_size)
    return per_tok * length


def ingest_windows(n: int, length: int, vocab: int, pad_id: int, seed: int):
    """[n, length] int32 token ids and mask: 32 to `length` random ids a
    window, padded with pad_id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(32, length + 1, size=n)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab, size=(n, length)).astype(np.int32)
    return np.where(mask > 0, ids, pad_id).astype(np.int32), mask


def recall_ids(got, oracle) -> float:
    """Mean share of each oracle row's ids among got's (both [Q, k])."""
    got, oracle = got.cpu().tolist(), oracle.cpu().tolist()
    return sum(len(set(g) & set(o)) / len(o) for g, o in zip(got, oracle)) / len(oracle)


def phase9_ingest(label: str, seed: int, model_dir: str, dev) -> None:
    """The bulk path per fetch dtype, against the chunked path, then the
    data-parallel encode over [dev, dev] (and every card, where there are
    several) against one device."""
    import numpy as np
    import torch

    from memex_tpu_torch.embed import EmbeddingEngine

    outs = {}
    for dtype in FETCH_DTYPES:
        eng = EmbeddingEngine(model_dir, max_batch=INGEST_BATCH, device=dev, fetch_dtype=dtype)
        L = eng.max_seq_length
        if not outs:
            ids, mask = ingest_windows(INGEST_N, L, eng.cfg.vocab_size, eng.tokenizer.pad_id,
                                       seed + 9)
        phases: dict = {}
        bulk = eng._encode_bulk
        eng._encode_bulk = lambda i, m, o: bulk(i, m, o, phases=phases)  # its telemetry
        eng._encode_padded(ids, mask)  # first use of the shapes
        phases.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vecs = eng._encode_padded(ids, mask)
        wall = time.perf_counter() - t0
        check(set(phases) == {"dispatch_s", "device_sync_s", "fetch_s"},
              f"{dtype}: _encode_padded did not take _encode_bulk")
        check(vecs.shape == (INGEST_N, eng.dim) and vecs.dtype == np.float32
              and bool(np.isfinite(vecs).all()), f"{dtype}: bad ingest output")
        norms = np.linalg.norm(vecs, axis=1)
        check(float(np.abs(norms - 1).max()) < 1e-2, f"{dtype}: vectors are not unit norm")
        outs[dtype] = vecs
        flop = INGEST_N * encoder_flop_per_window(eng.cfg, L)
        print(f"[{label}] phase9 ingest fetch_dtype={dtype} windows={INGEST_N} L={L} "
              f"B={INGEST_BATCH} seconds={wall:.4f} windows_per_s={INGEST_N / wall:.1f} "
              f"dispatch_s={phases['dispatch_s']:.4f} device_sync_s="
              f"{phases['device_sync_s']:.4f} fetch_s={phases['fetch_s']:.4f} "
              f"bound_windows_per_s={INGEST_N / (flop / BF16_PEAK):.1f} (encoder matmuls "
              f"{flop / INGEST_N / 1e9:.2f} GFLOP a window at {BF16_PEAK / 1e12:.0f} TFLOP/s "
              f"bf16)", flush=True)
        if dtype == "float32":
            dev_ms, wall_ms, n = device_busy(lambda: eng._encode_padded(ids, mask))
            print(f"[{label}] phase9 ingest float32 busy_share={dev_ms / wall_ms:.3f} "
                  f"(device {dev_ms:.2f} ms of {wall_ms:.2f} ms, {n} kernels)", flush=True)
            for name, k_ms, count in top_kernels(lambda: eng._encode_padded(ids, mask)):
                print(f"[{label}] phase9 ingest float32 kernel ms={k_ms:.2f} "
                      f"launches={count} {name[:90]}", flush=True)
            # The chunked path on the same ids: pieces of 7 x 512 windows,
            # each below the bulk threshold, in the bulk path's 512-row groups.
            piece = 7 * INGEST_BATCH
            chunked = np.concatenate([eng._encode_padded(ids[lo : lo + piece],
                                                         mask[lo : lo + piece])
                                      for lo in range(0, INGEST_N, piece)])
            diff = float(np.abs(chunked - vecs).max())
            print(f"[{label}] phase9 ingest bulk vs chunked float32 max_abs_diff={diff:.3e}",
                  flush=True)
            check(diff <= DP_TOL, f"bulk and chunked paths differ by {diff:.3e}")
        del eng
    for dtype in FETCH_DTYPES[1:]:
        want = torch.from_numpy(outs["float32"]).to(getattr(torch, dtype)).float().numpy()
        check(np.array_equal(outs[dtype], want),
              f"the {dtype} fetch is not the float32 output rounded on the device")
        print(f"[{label}] phase9 ingest {dtype} output == float32 output rounded to {dtype}: "
              f"bit_equal=True", flush=True)

    one = EmbeddingEngine(model_dir, max_batch=INGEST_BATCH, device=dev)
    want = one._encode_padded(ids[:DP_N], mask[:DP_N])
    del one
    lists = [[dev, dev]]
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        lists.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    for devices in lists:
        eng = EmbeddingEngine(model_dir, max_batch=INGEST_BATCH, device=dev, devices=devices)
        got = eng._encode_padded(ids[:DP_N], mask[:DP_N])
        diff = float(np.abs(got - want).max())
        names = ",".join(str(d) for d in devices)
        print(f"[{label}] phase9 data-parallel devices=[{names}] windows={DP_N} replicas="
              f"{len({id(r) for r in eng._replicas})} max_abs_diff_vs_one_device={diff:.3e} "
              f"(bar {DP_TOL})", flush=True)
        check(diff <= DP_TOL, f"data-parallel encode differs by {diff:.3e} > {DP_TOL}")
        del eng


def phase9(label: str, seed: int, work: str, flat_ms: dict, device: str = "cuda:0") -> dict:
    """Ingest (phase9_ingest), then on 1,048,576 x 384 float32 rows drawn on
    the card: FlatIndex.search through ops.host.fetch against .cpu()
    copies, score_topk's four methods against the float32 oracle, and the
    int8q rerank (K2) against its plain version. Returns the launches of
    K1 and K2 in the searches and reranks."""
    import torch

    from memex_tpu_torch.index import flat as flat_mod
    from memex_tpu_torch.index.flat import FlatIndex
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops.topk import score_topk

    dev = torch.device(device)
    phase9_ingest(label, seed, os.path.join(work, "model"), dev)
    torch.cuda.empty_cache()
    launches = dict.fromkeys(ft.LAUNCHES, 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    db = unit_rows(N_ROWS, DIM, gen, dev)
    src = torch.randperm(N_ROWS, generator=gen, device=dev)[:128]
    q = db[src] + 0.05 / DIM ** 0.5 * torch.randn((128, DIM), generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    q_np = q.cpu().numpy()

    # ops.host.fetch: FlatIndex.search's copies back.
    index = FlatIndex(DIM, capacity=N_ROWS, device=dev)
    index.add(db.cpu().numpy(), [f"r{i}" for i in range(N_ROWS)])

    def cpu_copies(*tensors):
        return tuple(t.cpu().numpy() for t in tensors)

    for Q in TIMED_Q:
        ft.reset_launches()
        hits = index.search(q_np[:Q], 10)
        launches["fused_topk"] += ft.LAUNCHES["fused_topk"]
        check(ft.LAUNCHES["fused_topk"] == 1, f"FlatIndex.search Q={Q} launched K1 "
              f"{ft.LAUNCHES['fused_topk']}x")
        fetch = flat_mod.fetch
        flat_mod.fetch = cpu_copies
        try:
            ref = index.search(q_np[:Q], 10)
        finally:
            flat_mod.fetch = fetch
        check(hits == ref, f"FlatIndex.search Q={Q}: hits through fetch differ from .cpu()")
        print(f"[{label}] phase9 fetch FlatIndex.search float32 Q={Q} hits == .cpu() copies' "
              f"median_ms={search_ms(index, q_np[:Q]):.3f} (phase 3: {flat_ms[Q]:.3f})",
              flush=True)
    del index
    torch.cuda.empty_cache()

    # score_topk at Q = 128, k = 10.
    ov, oi = oracle_scores(q, db)
    methods = {}
    for method in ("exact_f32", "exact", "blockwise", "approx"):
        v, i = score_topk(db, q, 10, method=method)
        ms = cuda_ms(lambda: score_topk(db, q, 10, method=method), runs=5, warmup=1)
        methods[method] = (v, i)
        print(f"[{label}] phase9 score_topk method={method} Q=128 rows={N_ROWS} "
              f"ms={ms:.3f} recall_at_10_vs_f32_oracle={recall_ids(i, oi):.4f}", flush=True)
    v, i = methods["exact_f32"]
    check(torch.equal(i.long(), oi) and torch.equal(v, ov),
          "score_topk exact_f32 differs from the float32 oracle")
    for method in ("exact", "approx"):
        check(all(torch.equal(a, b) for a, b in zip(methods[method], methods["blockwise"])),
              f"score_topk {method} differs from blockwise")
    rec = recall_ids(methods["blockwise"][1], oi)
    check(rec >= 0.99, f"score_topk bf16 methods: recall@10 {rec:.4f} < 0.99")

    # K2 under the int8q rerank: ~1% dead rows, count = N - 12345.
    codes, scales = ft.quantize_rows_int8(db)
    alive = (torch.rand(N_ROWS, generator=gen, device=dev) > 0.01).float()
    count = N_ROWS - 12345
    live = (torch.arange(N_ROWS, device=dev) < count) & (alive > 0)
    oracle = torch.topk(torch.where(live, q @ db.T, -float("inf")), 10, dim=1).indices
    del db
    torch.cuda.empty_cache()
    kw = dict(count=count, alive=alive)
    for Q in TIMED_Q:
        qq = q[:Q]
        ft.reset_launches()
        kv, ki = ft.fused_score_topk_int8q_rerank(codes, scales, qq, 10, **kw)
        n = ft.LAUNCHES["fused_topk_int8q"]
        launches["fused_topk_int8q"] += n
        check(n == 1, f"int8q rerank Q={Q} launched K2 {n}x")
        q8, _ = ft.quantize_rows_int8(qq)
        bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, banks=4, **kw)
        plain = ft.int8q_bank_reference(codes, scales, q8, banks=4, **kw)
        bit_equal(bank[0] + bank[1], plain[0] + plain[1], f"int8q rerank coarse bank Q={Q}")
        pv, pi = ft.fused_score_topk_int8q_rerank_reference(codes, scales, qq, 10, **kw)
        err = (kv - pv).abs().max().item()
        check(torch.equal(ki, pi) and err <= RERANK_TOL,
              f"int8q rerank Q={Q}: ids differ or values by {err:.3e}")
        check(bool((alive[ki.long()] > 0).all()) and int(ki.max()) < count,
              f"int8q rerank Q={Q}: a dead or unfilled row among the hits")
        _, ci = ft.fused_score_topk_int8q(codes, scales, qq, 10, banks=4, **kw)
        rr, rc = recall_ids(ki, oracle[:Q]), recall_ids(ci, oracle[:Q])
        ms = cuda_ms(lambda: ft.fused_score_topk_int8q_rerank(codes, scales, qq, 10, **kw))
        c_ms = cuda_ms(lambda: ft.fused_score_topk_int8q(codes, scales, qq, 10, banks=4, **kw))
        print(f"[{label}] phase9 int8q rerank Q={Q} K2_launches={n} coarse_bank_bit_equal=True "
              f"max_abs_err_vs_plain={err:.3e} recall_at_10_vs_f32_oracle={rr:.4f} "
              f"(int8q alone {rc:.4f}) ms={ms:.4f} (int8q alone {c_ms:.4f})", flush=True)
        if Q == max(TIMED_Q):
            check(rr >= rc, f"int8q rerank recall@10 {rr:.4f} below int8q's {rc:.4f}")
    return launches


def add_path(launches: dict, stats: dict, path: dict, errs: dict, what: str) -> None:
    """Fold a path's launches and bank errors into the kernels line: each of
    K1-K5 must have launched on it."""
    for name in ("fused_topk", "fused_topk_int8q", "fused_topk_int8", "fused_topk_int4q",
                 "ivf_batch"):
        check(path[name] > 0, f"{what} launched {name} 0 times")
        launches[name] += path[name]
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], errs[name])


# -- phase 10 ------------------------------------------------------------------
# The recall/QPS harness (memex_tpu_torch/benchmarks/) through its entry
# points, at all-MiniLM-L12-v2 width: run.main on memex_tpu's clustered
# corpus at 1M rows, the blocked device oracle, the native HNSW against the
# device tiers, and llm_bench.main at TinyLlama-1.1B geometry.

HARNESS_N = 1 << 20
HARNESS_TIERS = ("flat", "flat_bf16", "flat_int8", "ivf_int8")
HARNESS_BARS = {"flat": 0.95, "flat_bf16": 0.95, "flat_int8": 0.95, "ivf_int8": 0.93}
ORACLE_BLOCK = 262144
ORACLE_RECALL = 0.999
ORACLE_TIE = 1e-5    # a mismatch's float64 score from the 10th best's
HNSW_RUN_N = 8192
HNSW_N, HNSW_CENTRES, HNSW_Q, HNSW_SEED = 8192, 2048, 64, 4242  # memex_tpu's test
LLM_BENCH_GEOMETRY = "tinyllama-1.1b"


def json_lines(fn, argv: list[str]) -> list[dict]:
    """Run an entry point's main(argv), print its stdout and return the
    JSON objects it printed, one a line; it must exit 0."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    text = out.getvalue()
    print(text, end="", flush=True)
    check(rc == 0, f"main({' '.join(argv)}) exited {rc}")
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def harness_run(label: str, launches: dict, device: str) -> tuple:
    """(a) run.main at 1M rows on the card. Returns the corpus and queries
    it drew (the same bytes make_corpus gives for its arguments)."""
    from memex_tpu_torch.benchmarks import datasets, run
    from memex_tpu_torch.ops import fused_topk as ft

    drawn = {}

    def keep_corpus(*a, **kw):
        drawn["corpus"] = datasets.make_corpus(*a, **kw)
        return drawn["corpus"]

    run.make_corpus = keep_corpus
    try:
        ft.reset_launches()
        rows = json_lines(run.main, ["--n", str(HARNESS_N), "--q", "32", "--k", "10",
                                     "--tiers", ",".join(HARNESS_TIERS), "--device", device])
        path = dict(ft.LAUNCHES)
    finally:
        run.make_corpus = datasets.make_corpus
    check([r["tier"] for r in rows] == list(HARNESS_TIERS), f"run.main printed {rows}")
    for r in rows:
        check(r["recall_at_k"] >= HARNESS_BARS[r["tier"]],
              f"run.main {r['tier']}: recall@10 {r['recall_at_k']} < {HARNESS_BARS[r['tier']]}")
    ivf = "ivf_batch" if path["ivf_batch"] else "ivf_probe"
    print(f"[{label}] phase10 run.main n={HARNESS_N} launches K1={path['fused_topk']} "
          f"K2={path['fused_topk_int8q']} ivf_int8 on {ivf}={path[ivf]} (K5 ivf_batch="
          f"{path['ivf_batch']}, K7 ivf_probe={path['ivf_probe']}); recall bars "
          f"{HARNESS_BARS}", flush=True)
    for name in ("fused_topk", "fused_topk_int8q", ivf):
        check(path[name] > 0, f"run.main launched {name} 0 times")
    for name, n in path.items():
        launches[name] += n
    corpus = drawn["corpus"]
    return corpus, datasets.make_queries(corpus, 32)


def harness_oracle(label: str, corpus, queries, device: str) -> None:
    """(b) The blocked device oracle against the numpy one: recall, and
    every mismatch a near-tie in float64."""
    import numpy as np

    from memex_tpu_torch.benchmarks import datasets

    t0 = time.perf_counter()
    got = datasets._oracle_topk_device(corpus, queries, 10, device, block=ORACLE_BLOCK)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = datasets.oracle_topk(corpus, queries, 10)
    host_s = time.perf_counter() - t0
    rec = float(np.mean([len(set(g) & set(r)) / 10 for g, r in zip(got.tolist(),
                                                                      ref.tolist())]))
    worst = 0.0
    for qi, (g, r) in enumerate(zip(got.tolist(), ref.tolist())):
        odd = sorted(set(g) ^ set(r))
        if odd:
            q64 = queries[qi].astype(np.float64)
            kth = np.sort(corpus[r].astype(np.float64) @ q64)[0]
            worst = max(worst, float(np.max(np.abs(corpus[odd].astype(np.float64) @ q64
                                                   - kth))))
    print(f"[{label}] phase10 _oracle_topk_device block={ORACLE_BLOCK} vs numpy oracle "
          f"recall_at_10={rec:.4f} (bar {ORACLE_RECALL}) worst mismatch float64 gap "
          f"{worst:.3e} (bar {ORACLE_TIE}) seconds={dev_s:.3f} (numpy {host_s:.3f})",
          flush=True)
    check(rec >= ORACLE_RECALL, f"device oracle recall@10 {rec:.4f} < {ORACLE_RECALL}")
    check(worst <= ORACLE_TIE, f"device oracle mismatch {worst:.3e} is no near-tie")


def harness_hnsw(label: str, launches: dict, device: str) -> None:
    """(c) run.main's hnsw tier, then hnsw_recall at memex_tpu's test
    configuration: every device tier at or above HNSW's recall, and a
    second build_or_load a cache hit with the same ids."""
    import numpy as np
    import torch

    from memex_tpu_torch.benchmarks import hnsw_recall as hr
    from memex_tpu_torch.benchmarks import run
    from memex_tpu_torch.index import FlatIndex, IVFIndex
    from memex_tpu_torch.ops import fused_topk as ft

    (row,) = json_lines(run.main, ["--n", str(HNSW_RUN_N), "--q", "32", "--k", "10",
                                   "--tiers", "hnsw", "--device", device])
    print(f"[{label}] phase10 run.main hnsw n={HNSW_RUN_N} build_s={row['build_s']} "
          f"(one core) recall_at_10={row['recall_at_k']}", flush=True)

    dev = torch.device(device)
    corpus = hr.make_corpus(HNSW_N, DIM, seed=HNSW_SEED, centers=HNSW_CENTRES)
    queries = hr.make_queries(HNSW_Q, DIM, seed=HNSW_SEED, centers=HNSW_CENTRES)
    exact = hr.exact_topk_host(corpus, queries, 10)
    cache = tempfile.mkdtemp(prefix="memex_hnsw_")
    try:
        graph, build_s = hr.build_or_load(corpus, seed=HNSW_SEED, cache_dir=cache)
        ids = graph.search(queries, 10, ef=hr.EF_SEARCH_REF)
        hnsw_rec = hr.recall_against(exact, ids)
        again, again_s = hr.build_or_load(corpus, seed=HNSW_SEED, cache_dir=cache)
        same = bool(np.array_equal(again.search(queries, 10, ef=hr.EF_SEARCH_REF), ids))
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    print(f"[{label}] phase10 hnsw_recall n={HNSW_N} M={hr.M_REF} efc={hr.EFC_REF} "
          f"ef={hr.EF_SEARCH_REF} build_s={build_s:.3f} recall_at_10={hnsw_rec:.4f}; second "
          f"build_or_load build_s={again_s} ids_equal={same}", flush=True)
    check(again_s == 0.0 and same, "hnsw_recall: the cached graph was not a hit with the "
          "same ids")
    names = [f"r{i}" for i in range(HNSW_N)]

    def recall(hits) -> float:
        return float(np.mean([len({int(s[1:]) for s, _ in h} & set(e.tolist())) / 10
                              for h, e in zip(hits, exact)]))

    tiers = {"f32": ("fused_topk", dict(dtype="float32")),
             "bf16": ("fused_topk", dict(dtype="bfloat16")),
             "int8": ("fused_topk_int8", dict(dtype="int8", query_quantize=False)),
             "int8q": ("fused_topk_int8q", dict(dtype="int8")),
             "int4": ("fused_topk_int4q", dict(dtype="int4")),
             "ivf_int8": (None, None)}
    got = {}
    for tier, (kernel, opts) in tiers.items():
        if opts is not None:
            index = FlatIndex(DIM, capacity=HNSW_N, device=dev, **opts)
            index.add(corpus, names)
        else:
            index = IVFIndex(DIM, n_clusters=64, nprobe=8, dtype="int8", device=dev)
            index.build(corpus, names)
            index.calibrate_operating_point(target_recall=0.95)
        ft.reset_launches()
        got[tier] = recall(index.search(queries, 10))
        path = dict(ft.LAUNCHES)
        if kernel is None:
            kernel = "ivf_batch" if path["ivf_batch"] else "ivf_probe"
        check(path[kernel] > 0, f"hnsw_recall {tier}: the search launched {kernel} 0 times")
        for name, n in path.items():
            launches[name] += n
        print(f"[{label}] phase10 hnsw_recall {tier} on the card {kernel}_launches="
              f"{path[kernel]} recall_at_10={got[tier]:.4f} (HNSW {hnsw_rec:.4f})", flush=True)
        del index
    for tier, rec in got.items():
        check(rec >= hnsw_rec, f"hnsw_recall {tier}: recall@10 {rec:.4f} < HNSW's "
              f"{hnsw_rec:.4f}")


def phase10(label: str, tiny_llama: dict, device: str = "cuda") -> dict:
    """The harness's four readings, (a)-(d). Returns the launches of its
    searches, by kernel."""
    import torch

    from memex_tpu_torch.benchmarks import llm_bench

    launches = dict.fromkeys(REPLACES, 0)
    corpus, queries = harness_run(label, launches, device)
    harness_oracle(label, corpus, queries, device)
    del corpus, queries
    harness_hnsw(label, launches, device)
    torch.cuda.empty_cache()
    (row,) = json_lines(llm_bench.main, ["--geometry", LLM_BENCH_GEOMETRY, "--device", device])
    print(f"[{label}] phase10 llm_bench {LLM_BENCH_GEOMETRY} bf16: prefill_ms={row['prefill_ms']} "
          f"batch_tok_per_s={row['batch_tok_per_s']} stream_tok_per_s="
          f"{row['stream_tok_per_s']} first_token_ms={row['first_token_ms']} compile_s="
          f"{row['compile_s']}; phase 6 TinyLlama-1.1B bf16: prefill_ms="
          f"{tiny_llama['prefill_ms']:.3f} batch_tok_per_s={tiny_llama['batch_tok_per_s']:.2f} "
          f"stream_tok_per_s={tiny_llama['stream_tok_per_s']:.2f} first_token_ms="
          f"{tiny_llama['first_token_ms']:.3f}", flush=True)
    torch.cuda.empty_cache()
    return launches


# -- phase 11 ------------------------------------------------------------------
# The benchmark entry point (memex_tpu_torch/bench.py) through its main():
# every stage, scale_10M at 1M rows, llm_decode skipped (phases 6 and 10
# drive llm_bench), under a budget that covers every other stage. main's
# recall_vs_hnsw returns `skipped`: no 1M graph is cached between runs and
# building one takes ~22 minutes on one core. So the stage runs once more
# on its own at 8,192 rows, where the graph builds in ~4 s, and its
# card part (K2 on host-quantized rows, IVFIndex.build_device, the
# recall-target margin calibration, K5) runs in every smoke.

BENCH_ENV = {"MEMEX_BENCH_10M_BLOCKS": "1", "MEMEX_BENCH_SKIP_LLM_DECODE": "1",
             "MEMEX_BENCH_BUDGET_S": "3000"}
BENCH_STAGES = ("scale_10M", "sharded_ivf_1M", "recall_vs_hnsw", "serve_1M",
                "bulk_load_1M_s")  # and e2e, whose keys merge into `e2e` itself
BENCH_E2E_KEYS = ("ingest_docs_per_s", "query_p50_ms", "query_p99_ms",
                  "query_concurrent_qps", "query_store_rows")
# PERF.md section 2's bars: flat tiers 0.95 and their refine tiers 0.99;
# IVF int8 and int4 0.93, int8+refine 0.95 (the 10M configuration's
# routing, here on 1M rows, and the sharded IVF).
BENCH_FLAT_BAR, BENCH_FLAT_REFINE_BAR = 0.95, 0.99
BENCH_IVF_BAR, BENCH_IVF_REFINE_BAR = 0.93, 0.95
# recall_vs_hnsw at 1/128 of its 1M rows with the 1M stage's geometry: 128
# rows a centre (64 centres, not 8,192), 8 centres an IVF cluster (8
# clusters, not 1,024), nprobe 16 / 128 -> 1. Held to section 2's bars for
# its card tiers (int8q flat 0.95, IVF int8 0.93); HNSW's own recall here
# is near 1, so "at or above HNSW" is not asked of them at this size.
BENCH_HNSW_KW = dict(n1=8192, centers=64, n_clusters=8, nprobe=1)


def bench_stage_seconds(docs: list[dict]) -> dict:
    """Seconds of each stage, from the elapsed_s of the documents main()
    printed after each one (a stage's key, or its _error, appears in `e2e`
    with the emit that follows it; e2e's own keys merge into `e2e`)."""
    seen, prev, out = set(), 0.0, {}
    for doc in docs:
        keys = set(doc.get("e2e", {})) - seen
        if keys:
            if not seen:
                out["kernels"] = prev
            stage = "e2e" if keys & set(BENCH_E2E_KEYS) else sorted(keys)[0].removesuffix(
                "_error")
            out[stage] = round(doc.get("elapsed_s", 0) - prev, 1)
            seen |= keys
        prev = doc.get("elapsed_s", prev)
    return out


def phase11(label: str, work: str, device: str = "cuda") -> tuple[dict, dict]:
    """bench.main on the card (its recall_vs_hnsw `skipped`), then that
    stage alone at 8,192 rows. Returns the launches of both, by kernel,
    and bench.main's `e2e` document."""
    import io

    from memex_tpu_torch import bench
    from memex_tpu_torch.ops import fused_topk as ft

    env = {**BENCH_ENV, "MEMEX_BENCH_DOC_PATH": os.path.join(work, "BENCH_FULL.json")}
    saved = {k: os.environ.get(k) for k in (*env, "MEMEX_BENCH_BUILD_HNSW")}
    os.environ.update(env)
    os.environ.pop("MEMEX_BENCH_BUILD_HNSW", None)
    out = io.StringIO()
    cache = tempfile.mkdtemp(prefix="memex_bench_hnsw_", dir=work)
    try:
        ft.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--device", device])
        launches = dict(ft.LAUNCHES)
        os.environ["MEMEX_BENCH_BUILD_HNSW"] = "1"
        ft.reset_launches()
        hnsw = bench.bench_recall_vs_hnsw(device, cache_dir=cache, **BENCH_HNSW_KW)
        hnsw_launches = dict(ft.LAUNCHES)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"bench.main exited {rc}")
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    compact, full = lines[-1], lines[-2]
    print(f"[{label}] phase11 bench compact line: {json.dumps(compact)}", flush=True)
    print(f"[{label}] phase11 bench stage seconds: {bench_stage_seconds(lines[0::2])}",
          flush=True)
    check(compact["errors"] == 0, f"bench stages failed: {compact.get('error_stages')}")
    check(full["skipped_stages"] == [{"stage": "llm_decode", "why": "env"}],
          f"bench skipped {full['skipped_stages']}")
    e2e = full["e2e"]
    for stage in BENCH_STAGES:
        check(stage in e2e, f"bench recorded no {stage}")
    for key in BENCH_E2E_KEYS:
        check(key in e2e, f"bench's e2e stage recorded no {key}")
    for name, row in full["tiers"].items():
        bar = BENCH_FLAT_REFINE_BAR if "refine" in name else BENCH_FLAT_BAR
        print(f"[{label}] phase11 kernels {name} Q={row['q']} qps={row['qps']} "
              f"recall_at_10={row['recall']} (bar {bar}) hbm_gbps={row.get('hbm_gbps')} "
              f"pct_peak_hbm={row.get('pct_peak_hbm')} bound={row.get('bound')}", flush=True)
        check(row["recall"] >= bar, f"bench kernels {name}: recall@10 {row['recall']} < {bar}")
    # scale_10M raises (and main records scale_10M_error) if block 0 drawn
    # again from its seed differs: errors == 0 above says the check held.
    s10 = e2e["scale_10M"]
    for key, bar in (("ivf_recall_at_10_vs_exact_f32", BENCH_IVF_BAR),
                     ("ivf_int4_recall_at_10_vs_exact_f32", BENCH_IVF_BAR),
                     ("ivf_refine_recall_at_10_vs_exact_f32", BENCH_IVF_REFINE_BAR)):
        check(s10[key] >= bar, f"scale_10M {key} {s10[key]} < {bar}")
    sh = e2e["sharded_ivf_1M"]
    check(sh["recall_at_10_vs_int8_exact"] >= BENCH_IVF_BAR,
          f"sharded_ivf_1M recall@10 {sh['recall_at_10_vs_int8_exact']} < {BENCH_IVF_BAR}")
    ref = sh["refine"]["refine"]["recall_at_10_vs_exact_f32"]
    check(ref >= BENCH_IVF_REFINE_BAR, f"sharded_ivf_1M refine recall@10 {ref} < "
          f"{BENCH_IVF_REFINE_BAR}")
    check(set(e2e["recall_vs_hnsw"]) == {"skipped"},
          f"bench.main's recall_vs_hnsw found a 1M graph: {e2e['recall_vs_hnsw']}")
    print(f"[{label}] phase11 scale_10M n={s10['n']} ivf recall_at_10 int8 "
          f"{s10['ivf_recall_at_10_vs_exact_f32']} int4 "
          f"{s10['ivf_int4_recall_at_10_vs_exact_f32']} refine "
          f"{s10['ivf_refine_recall_at_10_vs_exact_f32']}; sharded_ivf_1M "
          f"{sh['recall_at_10_vs_int8_exact']} refine {ref}; recall_vs_hnsw at 1M "
          f"{e2e['recall_vs_hnsw']}; launches {launches}", flush=True)
    for name in ("fused_topk", "fused_topk_int8q", "fused_topk_int8", "fused_topk_int4q",
                 "ivf_batch", "ivf_batch4"):
        check(launches[name] > 0, f"bench.main launched {name} 0 times")

    # The recall_vs_hnsw stage at 8,192 rows: HNSW built, its card tiers at
    # their bars.
    tiers = hnsw["tiers"]
    print(f"[{label}] phase11 recall_vs_hnsw {BENCH_HNSW_KW} hnsw {hnsw['hnsw']} int8q_flat "
          f"{tiers['int8q_flat']} ivf_int8_pruned {tiers['ivf_int8_pruned']}; launches "
          f"{hnsw_launches}", flush=True)
    check(isinstance(hnsw["hnsw"]["build_s"], float), "recall_vs_hnsw built no graph")
    for tier, bar in (("int8q_flat", BENCH_FLAT_BAR), ("ivf_int8_pruned", BENCH_IVF_BAR)):
        rec = tiers[tier]["recall_at_10_vs_exact"]
        check(rec >= bar, f"recall_vs_hnsw {tier}: recall@10 {rec} < {bar}")
    for name in ("fused_topk_int8q", "ivf_batch"):
        check(hnsw_launches[name] > 0, f"recall_vs_hnsw launched {name} 0 times")
    for name, n in hnsw_launches.items():
        launches[name] += n
    return launches, e2e


# -- phase 12 ------------------------------------------------------------------
# The last code that ran memex_tpu, ported: bench.py's two real-text stages
# on SURVEY.md (real English prose in the repository; the upstream demo
# document they read by default is not), the root benchmarks/ sweeps at 1M x
# 384, and clippy against a port server with --local-llm on phase 6's
# TinyLlama-geometry checkpoint. Nothing here reaches the network:
# `_resolve_weights`' probe is refused (random weights, reason recorded).

REALTEXT_PATH = os.path.join(ROOT, "SURVEY.md")
REALTEXT_WINDOWS = 16384
SKIPPED_STAGE = {"skipped": "reference corpus not present"}
# Tie-aware recall@10 of the tiers with an exact rerank (memex_tpu's record on
# its text, BENCH_FULL.json: float32 0.9984, int8_refine 0.9969); int8's
# quantization floor (0.7344 there) has no bar. sotu_e2e's int8 store against
# float32 on the same embeddings (1.0 there).
REALTEXT_BAR = {"float32": 0.95, "int8_refine": 0.95}
SOTU_BAR = 0.9
SWEEP_BAR = 0.95  # every sweep row holds the flat tiers' recall bar
SWEEP_ROW_KEYS = {
    "keep2_validate": {"variant", "qps", "p50_batch_ms", "recall_at_10", "compile_s"},
    "int4_bank_sweep": {"variant", "qps", "p50_batch_ms", "recall_at_10", "compile_s"},
    "int4_refine_sweep": {"variant", "qps", "p50_batch_ms", "recall_at_10"},
    "int4_bank_sweep2": {"variant", "recall", "misses"},
}
# Every (kernel, banks, deferred unpack, keep2) the sweeps launch; phase 1
# holds K2 at banks 4 and 8 and K4 at 8 and 16, so K4 at 32 (S = 4096) is
# new. Each is held bit-equal at the sweeps' arguments (every row, no mask).
SWEEP_COMBOS = (
    ("K2", 4, None, False), ("K2", 4, None, True), ("K2", 8, None, False),
    ("K4", 8, True, False), ("K4", 8, False, False), ("K4", 16, True, False),
    ("K4", 16, False, False), ("K4", 8, True, True), ("K4", 16, True, True),
    ("K4", 32, True, False),
)
CLIPPY_QUESTION = "how does the inverted file index choose which clusters to probe?"


class _Offline:
    """socket.create_connection refused while inside: bench's weights probe
    records the offline reason instead of opening a connection."""

    def __enter__(self):
        self.saved = socket.create_connection

        def refuse(*a, **kw):
            raise OSError("the smoke opens no network connection")

        socket.create_connection = refuse

    def __exit__(self, *exc):
        socket.create_connection = self.saved


def phase12_realtext(label: str) -> dict:
    """bench_realtext_ivf on SURVEY.md at 16,384 windows, full MiniLM-L12
    width; its launches (K5 in the IVF tiers)."""
    from memex_tpu_torch import bench
    from memex_tpu_torch.ops import fused_topk as ft

    os.environ.pop("MEMEX_BENCH_REALTEXT_WINDOWS", None)
    ft.reset_launches()
    with _Offline():
        out = bench.bench_realtext_ivf("cuda", path=REALTEXT_PATH)
    path = dict(ft.LAUNCHES)
    check(out.get("windows") == REALTEXT_WINDOWS, f"ivf_prune_realtext gave {out}")
    check(out["weights"] == "random" and "offline" in out["weights_fallback_reason"],
          f"ivf_prune_realtext weights {out['weights']}")
    print(f"[{label}] phase12 ivf_prune_realtext windows={out['windows']} encode_s="
          f"{out['encode_s']} encode_windows_per_s={out['encode_windows_per_s']} "
          f"encode_roofline={json.dumps(out['encode_roofline'])} mean_pairwise_cos="
          f"{out['mean_pairwise_cos']} weights={out['weights']}", flush=True)
    for tier in ("int8", "int8_refine", "float32"):
        row = out[tier]
        pt = row["operating_point"]
        rec = row["recall_at_10_vs_exact_f32"]
        bar = REALTEXT_BAR.get(tier)
        print(f"[{label}] phase12 ivf_prune_realtext {tier} nprobe={pt['nprobe']} "
              f"prune_margin={pt['prune_margin']} recall_vs_full={pt['recall_vs_full']} "
              f"tie_recall_at_10={rec} (bar {bar}) id_recall_at_10={row['id_recall_at_10']} "
              f"union_clusters full={row['union_clusters_full']} "
              f"pruned={row['union_clusters_pruned']}", flush=True)
        check(0.0 <= rec <= 1.0 and (bar is None or rec >= bar),
              f"ivf_prune_realtext {tier}: tie-aware recall@10 {rec} < {bar}")
        check(row["union_clusters_pruned"] <= row["union_clusters_full"],
              f"ivf_prune_realtext {tier}: the margin grew the union")
    check(path["ivf_batch"] > 0, f"ivf_prune_realtext launched ivf_batch 0 times: {path}")
    return path


def phase12_sotu(label: str) -> dict:
    """bench_sotu on SURVEY.md; its launches (K2 in the int8 store)."""
    from memex_tpu_torch import bench
    from memex_tpu_torch.ops import fused_topk as ft

    ft.reset_launches()
    with _Offline():
        out = bench.bench_sotu("cuda", path=REALTEXT_PATH)
    path = dict(ft.LAUNCHES)
    print(f"[{label}] phase12 sotu_e2e windows={out['windows']} ingest_s={out['ingest_s']} "
          f"query_p50_ms={out['query_p50_ms']} top3_score={out['top3_score']} "
          f"recall_at_10_int8_vs_f32={out['recall_at_10_int8_vs_f32']} (bar {SOTU_BAR}) "
          f"weights={out['weights']}; K2 launches={path['fused_topk_int8q']}", flush=True)
    check(out["windows"] > 10 and out["top3_score"] is not None, f"sotu_e2e gave {out}")
    check(out["recall_at_10_int8_vs_f32"] >= SOTU_BAR,
          f"sotu_e2e int8 vs float32 recall@10 {out['recall_at_10_int8_vs_f32']} < {SOTU_BAR}")
    check(path["fused_topk_int8q"] > 0, "sotu_e2e launched fused_topk_int8q 0 times")
    return path


def phase12_sweeps(label: str) -> dict:
    """The four sweeps at 1M x 384 through their main(); their launches (K2
    and K4)."""
    import importlib

    from memex_tpu_torch.ops import fused_topk as ft

    launches = dict.fromkeys(REPLACES, 0)
    for name, keys in SWEEP_ROW_KEYS.items():
        mod = importlib.import_module(f"memex_tpu_torch.benchmarks.{name}")
        t0 = time.perf_counter()
        ft.reset_launches()
        out = mod.main("cuda", N_ROWS)
        path = dict(ft.LAUNCHES)
        rows = out["variants"] if name == "int4_bank_sweep2" else out
        for row in rows:
            check(set(row) == keys, f"{name} row keys {sorted(row)}")
            rec = row.get("recall_at_10", row.get("recall"))
            check(rec >= SWEEP_BAR, f"{name} {row['variant']}: recall@10 {rec} < {SWEEP_BAR}")
        kernels = ["fused_topk_int4q"] + ([] if name == "int4_bank_sweep"
                                          else ["fused_topk_int8q"])
        for kernel in kernels:
            check(path[kernel] > 0, f"{name} launched {kernel} 0 times")
        print(f"[{label}] phase12 {name} n={N_ROWS} rows={len(rows)} seconds="
              f"{time.perf_counter() - t0:.1f} launches K2={path['fused_topk_int8q']} "
              f"K4={path['fused_topk_int4q']}", flush=True)
        for k, n in path.items():
            launches[k] += n
    return launches


def phase12_combos(label: str) -> None:
    """Every K2/K4 combination the sweeps launch, bank against the plain
    version at the sweeps' arguments (bit-equal: both are exact integer
    dots)."""
    import torch

    from memex_tpu_torch.benchmarks import flat_sweep
    from memex_tpu_torch.ops import fused_topk as ft

    c = flat_sweep.make_case("cuda", N_ROWS, batches=1)
    q = c.oracle_q
    q8, _ = ft.quantize_rows_int8(q)
    for kernel, banks, deferred, keep2 in SWEEP_COMBOS:
        if kernel == "K2":
            kw = dict(count=N_ROWS, banks=banks, keep2=keep2)
            got = ft.fused_score_bank_int8q_cuda(c.db8, c.scales, q8, **kw)
            want = ft.int8q_bank_reference(c.db8, c.scales, q8, **kw)
            got, want = list(got[0] + got[1]), list(want[0] + want[1])
            new = banks not in (4, 8)
        else:
            kw = dict(count=N_ROWS, banks=banks, deferred=deferred, keep2=keep2)
            got = list(ft.int4q_candidates_cuda(c.db4, c.scales, q, **kw))
            want = list(ft.int4q_candidates_reference(c.db4, c.scales, q, **kw))
            new = banks not in (8, 16)
        what = (f"{kernel} S={banks * 128} "
                f"{'' if deferred is None else ('deferred ' if deferred else 'shift ')}"
                f"keep2={keep2} Q={q.shape[0]} count={N_ROWS}")
        bit_equal(got, want, f"sweep combination {what}")
        print(f"[{label}] phase12 {what} bank bit_equal=True"
              f"{' (not held by phase 1)' if new else ''}", flush=True)
    del c
    torch.cuda.empty_cache()


def phase12_clippy(label: str, seed: int, work: str) -> int:
    """`python -m memex_tpu_torch.clippy`'s commands against a port server
    on an int8 store (phase 2's encoder checkpoint): load-file SURVEY.md,
    ask with --local-llm on phase 6's TinyLlama-geometry checkpoint (bf16
    on the card, its text printed piece by piece as the ids decode),
    forget. Returns the ask's K2 launches."""
    import io

    from memex_tpu_torch import clippy

    toml = os.path.join(work, "llm.toml")
    check(os.path.exists(toml), "phase 6's LLM config is missing")
    model_dir = os.path.join(work, "model")
    if not os.path.exists(model_dir):
        write_checkpoint(model_dir, seed)
    env = dict(os.environ, EMBEDDING_MODEL=model_dir, MEMEX_FAKE_LLM="1",
               DATABASE_CONNECTION=f"sqlite://{work}/clippy.db",
               VECTOR_CONNECTION=f"tpu://{work}/vectors_clippy?dtype=int8")
    with port_server(work, "clippy", env) as base:
        local = clippy.LocalAnswerer(toml, "cuda")

        def run(args: list[str]) -> str:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = clippy.main(["--host", base, *args], local=local)
            check(rc == 0, f"clippy {args[-2:]} exited {rc}")
            print(f"[{label}] phase12 clippy {' '.join(args[-2:])[:60]!r} seconds="
                  f"{time.perf_counter() - t0:.3f}", flush=True)
            return out.getvalue()

        check("ingest completed" in run(["load-file", REALTEXT_PATH]), "clippy load-file failed")
        before = _launches(base, "fused_topk_int8q")
        said = run(["--local-llm", toml, "--device", "cuda", "ask", CLIPPY_QUESTION])
        launches = _launches(base, "fused_topk_int8q") - before
        last = local.last
        check("[2 context segments" in said, f"clippy ask: {said[-200:]!r}")
        # Random byte-level weights form valid UTF-8 only now and then, so
        # a piece holds many ids: the first token is the first id on the
        # host, the first piece the first text printed.
        check(last["tokens"] > 1 and len(last["pieces"]) > 1
              and "".join(last["pieces"]) in said,
              f"clippy ask streamed {last['tokens']} ids in {len(last['pieces'])} pieces")
        check(last["first_token_ms"] <= last["first_piece_ms"] <= last["total_ms"],
              f"clippy ask timings out of order: {last}")
        print(f"[{label}] phase12 clippy ask --local-llm TinyLlama-1.1B bf16: tokens="
              f"{last['tokens']} pieces={len(last['pieces'])} chars="
              f"{len(''.join(last['pieces']))} first_token_ms={last['first_token_ms']:.1f} "
              f"first_piece_ms={last['first_piece_ms']:.1f} total_ms={last['total_ms']:.1f}; "
              f"the search's K2 launches={launches}", flush=True)
        check(launches > 0, "clippy's search launched fused_topk_int8q 0 times")
        check("deleted" in run(["forget"]), "clippy forget failed")
        return launches


def phase12(label: str, seed: int, work: str, bench_e2e: dict) -> dict:
    """Phase 11's bench.main recorded the real-text stages as skipped (no
    upstream document beside the checkout); then each ported program.
    Returns their launches, by kernel."""
    for stage in ("ivf_prune_realtext", "sotu_e2e"):
        check(bench_e2e.get(stage) == SKIPPED_STAGE,
              f"bench.main recorded {stage} as {bench_e2e.get(stage)}")
    print(f"[{label}] phase12 bench.main recorded ivf_prune_realtext and sotu_e2e as "
          f"{SKIPPED_STAGE}", flush=True)
    launches = dict.fromkeys(REPLACES, 0)
    for part in (phase12_realtext(label), phase12_sotu(label), phase12_sweeps(label)):
        for name, n in part.items():
            launches[name] += n
    phase12_combos(label)
    launches["fused_topk_int8q"] += phase12_clippy(label, seed, work)
    print(f"[{label}] phase12 launches {launches}", flush=True)
    return launches


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # One rank of phase 8, spawned by phase 8 itself.
    ap.add_argument("--phase8-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if args.phase8_rank is not None:
        phase8_rank(args.phase8_rank, args.coordinator, args.work, args.seed)
        return 0

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA card",
              file=sys.stderr)
        return 1
    try:
        label = card_label()
        print(label, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t_all = time.perf_counter()
        t_phase = [t_all]

        def phase_done(n: int) -> None:
            now = time.perf_counter()
            print(f"[{label}] phase {n} seconds={now - t_phase[0]:.1f} "
                  f"(smoke so far {now - t_all:.1f})", flush=True)
            t_phase[0] = now

        stats = phase1(label, args.seed)
        phase_done(1)
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
            phase_done(2)
            launches, flat = phase3(label, args.seed, work)
            flat_ms = flat["ms"]["float32"]
            phase_done(3)
            ivf_launches, ivf_stats, ivf10m = phase4(label, args.seed, work)
            stats.update(ivf_stats)
            launches.update(ivf_launches)
            launches.update(http)
            phase_done(4)
            # Phase 5 is the sharded tiers' own path: each of K1-K5 must
            # launch there too. Its launches add to the line's.
            sharded, errs = phase5(label, args.seed, work, flat, ivf10m)
            del flat, ivf10m
            add_path(launches, stats, sharded, errs, "the sharded path")
            phase_done(5)
            # Phase 6, the local LLM: no scan kernel runs there, and its 7B
            # models need the card's memory to themselves.
            tiny_llama = phase6(label, args.seed, work)
            phase_done(6)
            # Phase 7, encoder fine-tuning; its server's searches run K1.
            ft = phase7(label, args.seed, work)
            check(ft > 0, "the fine-tuned encoder's searches launched fused_topk 0 times")
            launches["fused_topk"] += ft
            phase_done(7)
            # Phase 8, two ranks over a process group: K1-K5 on each rank's
            # shard, then two ranks of the server (K1).
            ranked, errs = phase8(label, args.seed, work)
            add_path(launches, stats, ranked, errs, "the two-rank path")
            phase_done(8)
            # Phase 9, the ingest paths, ops.host.fetch, score_topk and the
            # int8q rerank; its searches run K1 and its reranks K2.
            for name, n in phase9(label, args.seed, work, flat_ms).items():
                launches[name] += n
            phase_done(9)
            # Phase 10, the recall/QPS harness through run.main, the device
            # oracle, hnsw_recall and llm_bench.main: its searches run K1-K5.
            for name, n in phase10(label, tiny_llama).items():
                launches[name] += n
            phase_done(10)
            # Phase 11, the benchmark entry point through bench.main: its
            # stages run K1-K6.
            bench_launches, bench_e2e = phase11(label, work)
            for name, n in bench_launches.items():
                launches[name] += n
            phase_done(11)
            # Phase 12, the real-text stages, the flat sweeps and clippy:
            # K5, K2 and K4.
            for name, n in phase12(label, args.seed, work, bench_e2e).items():
                launches[name] += n
            phase_done(12)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"[{label}] smoke seconds={time.perf_counter() - t_all:.1f}", flush=True)
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
