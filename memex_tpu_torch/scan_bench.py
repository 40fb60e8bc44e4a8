"""Bank-only times of the scans K1, K2, K4 and K5 on one card, to compare
two checkouts of this repository in one call.

    python memex_tpu_torch/scan_bench.py [--root DIR] [--label NAME]
                                         [--kernels K1,K2,K4,K5] [--queries 1,32,128]

Imports memex_tpu_torch from DIR (default: the checkout holding this file),
builds its kernels there, and times with CUDA events (median of 20 after 3
warm-up calls):
  - K1, `fused_score_bank_cuda`, on 1,048,576 x 384 float32 and bf16 unit
    rows, count = N - 12345, ~1% dead rows, keep2 off;
  - K2, `fused_score_bank_int8q_cuda`, on the int8 codes of the same rows,
    banks = 4 (S = 512, the flat index's width), int8 queries;
  - K4, `int4q_candidates_cuda`, on their packed int4 codes, banks = 8, in
    shift and in deferred mode: the wrapper's time (it makes the scan's
    query operands from the float32 queries first) and, as kernel_ms, the
    scan alone on operands prepared beforehand;
  - K5, `ivf_batch_bank_cuda`, on an int8 table of the 10M IVF
    configuration's shape (C = 4096 clusters, M = 3072, D = 384, S = 1024,
    bucket sizes uniform in [1536, 3072]), over the union that
    `route_union` gives random unit queries at nprobe = 64;
at Q = 1, 32 and 128 (or --queries). Beside each time it prints the bound (the larger of
the bytes the function must move at 3.35 TB/s and its products at the
card's tensor-core peak for the product's type, live rows only) and one
PyTorch call of the same function's product on operands laid out
beforehand (library_ms): `torch.matmul` of bf16 operands for K1 and K5,
`torch._int_mm` of the int8 queries and codes for K2 and K4 (null where
its shape rules refuse the batch). One JSON line per measurement, with the card's
name and power limit. Inputs are made from --seed on the card, so two
checkouts see the same ones.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
PEAK_OPS_PER_S = {           # dense, NVIDIA's data sheet, at 700 W
    "bf16": 989e12,
    "int8": 1979e12,
    "fp32": 67e12,           # FP32 pipe, no tensor cores
}
N_ROWS, DIM, COUNT_GAP = 1 << 20, 384, 12345
IVF_C, IVF_M, IVF_NPROBE, IVF_S = 4096, 3072, 64, 1024


def bound(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move n_bytes and do n_ops operations of `kind`."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def k1_bound(q_n: int, live: int, limit: int, row_bytes: int, n_slots: int) -> tuple[float, str]:
    """K1 (non-exact): live rows and the alive entries below `limit` read,
    the queries read, the [Q, S] bank written; 2 * Q * D products a row."""
    n_bytes = live * row_bytes + limit * 4 + q_n * DIM * 4 + q_n * n_slots * 8
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16")


def k5_bound(q_n: int, live: int, n_chunks: int, row_bytes: int, n_slots: int,
             n_clusters: int) -> tuple[float, str]:
    """K5: the union's live rows (and their scales), its walk and the
    bucket sizes read, the queries read, the bank written."""
    n_bytes = (live * row_bytes + n_chunks * 4 + n_clusters * 4 + q_n * DIM * 4
               + q_n * n_slots * 8)
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16")


def k2_bound(q_n: int, live: int, limit: int, n_slots: int) -> tuple[float, str]:
    """K2: live int8 rows with their scales and the alive entries below
    `limit` read, the int8 queries read, the [Q, S] bank written; 2 * Q * D
    integer operations a row."""
    n_bytes = live * (DIM + 4) + limit * 4 + q_n * (DIM + 4) + q_n * n_slots * 8
    return bound(n_bytes, 2.0 * q_n * live * DIM, "int8")


def k4_bound(q_n: int, live: int, limit: int, n_slots: int, deferred: bool) -> tuple[float, str]:
    """K4: live packed rows (D / 2 bytes) with their scales, the alive
    entries, the float32 queries, the bank; 2 * Q * D operations a row, int8
    in shift mode, 16-bit floats in deferred mode."""
    n_bytes = live * (DIM // 2 + 4) + limit * 4 + q_n * DIM * 4 + q_n * n_slots * 8
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16" if deferred else "int8")


def int_mm_ms(a, b_t, what: str) -> float | None:
    """library_ms of an int8 x int8 product by torch._int_mm, or None where
    its shape rules refuse these operands."""
    import torch

    try:
        return cuda_ms(lambda: torch._int_mm(a, b_t))
    except RuntimeError as exc:
        print(f"library call torch._int_mm for {what} refused: {exc}", flush=True)
        return None


def pack_int4(rows):
    """(packed [N, D/2] int8 rows as the flat index stores them, byte j =
    16 * code[j + D/2] + code[j]; the int4 codes [N, D] as int8)."""
    import torch

    d = rows.shape[1]
    s4 = torch.clamp(rows.abs().amax(dim=1), min=1e-12) / 7.0
    c4 = torch.clamp(torch.round(rows / s4[:, None]), -7, 7).to(torch.int32)
    packed = (c4[:, : d // 2] + 16 * c4[:, d // 2 :]).to(torch.int8).contiguous()
    return packed, c4.to(torch.int8)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="K1,K2,K4,K5")
    ap.add_argument("--queries", default="1,32,128", help="batch sizes, comma-separated")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path[0] = root  # not this file's directory: its modules would shadow top-level names
    import torch

    if not torch.cuda.is_available():
        print("FAIL: this benchmark needs a CUDA card", file=sys.stderr)
        return 1
    from memex_tpu_torch import kernels
    from memex_tpu_torch.ops import fused_topk as ft
    from memex_tpu_torch.ops import ivf_batch as ib

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    card = card_label()
    label = args.label or root
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def emit(**rec):
        print(json.dumps({"label": label, "card": card, **rec}), flush=True)

    # K1 on the flat index's shapes.
    x = torch.randn((N_ROWS, DIM), generator=gen, device=dev)
    db32 = x / x.norm(dim=1, keepdim=True)
    del x
    alive = (torch.rand(N_ROWS, generator=gen, device=dev) > 0.01).float()
    limit = N_ROWS - COUNT_GAP
    live = int((alive[:limit] > 0).sum())
    queries = {}
    for q_n in (int(v) for v in args.queries.split(",")):
        q = torch.randn((q_n, DIM), generator=gen, device=dev)
        queries[q_n] = q / q.norm(dim=1, keepdim=True)
    for dtype in (torch.float32, torch.bfloat16) if "K1" in which else ():
        db = db32.to(dtype)
        rows16 = db[:limit].to(torch.bfloat16).contiguous()
        for q_n, q in queries.items():
            ms = cuda_ms(lambda: ft.fused_score_bank_cuda(db, q, count=limit, alive=alive))
            q16 = q.to(torch.bfloat16)
            lib_ms = cuda_ms(lambda: torch.matmul(q16, rows16.T))
            b_ms, b_by = k1_bound(q_n, live, limit, DIM * db.element_size(), 1024)
            emit(kernel="K1", rows=str(dtype).split(".")[-1], Q=q_n, n_rows=limit,
                 live_rows=live, ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del db, rows16

    # K2 and K4 on the int8 and the packed int4 codes of the same rows. The
    # library call multiplies all N rows (N % 8 == 0, as _int_mm asks).
    if which & {"K2", "K4"}:
        codes, scales = ft.quantize_rows_int8(db32)
        packed, c4 = pack_int4(db32)
    del db32
    torch.cuda.empty_cache()
    for q_n, q in queries.items() if "K2" in which else ():
        q8, _ = ft.quantize_rows_int8(q)
        ms = cuda_ms(lambda: ft.fused_score_bank_int8q_cuda(codes, scales, q8, count=limit,
                                                            alive=alive, banks=4))
        b_ms, b_by = k2_bound(q_n, live, limit, 512)
        emit(kernel="K2", rows="int8", Q=q_n, n_rows=limit, live_rows=live, ms=ms,
             library_ms=int_mm_ms(q8, codes.t(), "K2"), bound_ms=b_ms, bound_by=b_by)
    for deferred in (False, True) if "K4" in which else ():
        for q_n, q in queries.items():
            ms = cuda_ms(lambda: ft.int4q_candidates_cuda(packed, scales, q, count=limit,
                                                          alive=alive, banks=8,
                                                          deferred=deferred))
            # The kernel alone: the wrapper's own call, on operands and
            # outputs made beforehand.
            qa, qb = ft._int4_query_operands(q, deferred)
            vals, idx = ft._bank_outputs(packed, q_n, 1024, False)
            lib = kernels.library()
            stream = torch.cuda.current_stream().cuda_stream

            def kernel_only():
                err = lib.memex_fused_topk_int4q(
                    qa.data_ptr(), qb.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                    ft.INT4_SCALE, alive.data_ptr(), vals[0].data_ptr(), idx[0].data_ptr(),
                    None, None, q_n, DIM, 1024, limit, int(deferred), 0, stream)
                if err != 0:
                    raise RuntimeError(f"fused_topk_int4q launch failed: cudaError {err}")

            q8, _ = ft.quantize_rows_int8(q)
            b_ms, b_by = k4_bound(q_n, live, limit, 1024, deferred)
            emit(kernel="K4", rows="int4", mode="deferred" if deferred else "shift", Q=q_n,
                 n_rows=limit, live_rows=live, ms=ms, kernel_ms=cuda_ms(kernel_only),
                 library_ms=int_mm_ms(q8, c4.t(), "K4"), bound_ms=b_ms, bound_by=b_by)
    if which & {"K2", "K4"}:
        del codes, scales, packed, c4
    del alive
    torch.cuda.empty_cache()
    if "K5" not in which:
        return 0

    # K5 on an int8 table of the 10M configuration's shape.
    data = torch.randint(-127, 128, (IVF_C, IVF_M, DIM), generator=gen, device=dev,
                         dtype=torch.int8)
    rscales = torch.rand((IVF_C, IVF_M), generator=gen, device=dev) * 1e-2 + 1e-3
    sizes = torch.randint(IVF_M // 2, IVF_M + 1, (IVF_C,), generator=gen, device=dev,
                          dtype=torch.int32)
    c = torch.randn((IVF_C, DIM), generator=gen, device=dev)
    centroids = c / c.norm(dim=1, keepdim=True)
    flat = data.view(-1, DIM)
    for q_n, q in queries.items():
        clist, nact = ib.route_union(centroids, q, IVF_NPROBE)
        walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, IVF_S)
        ms = cuda_ms(lambda: ib.ivf_batch_bank_cuda(data, rscales, sizes, walk, n_chunks, q,
                                                    banks=IVF_S // 128))
        n_ch = int(n_chunks[0])
        w = walk[:n_ch].long()
        row = (w & 255)[:, None] * IVF_S + torch.arange(IVF_S, device=dev)[None, :]
        ok = row < sizes.long()[w >> 8][:, None]
        idx = ((w >> 8)[:, None] * IVF_M + row)[ok]
        union16 = flat[idx].to(torch.bfloat16)
        q16 = q.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(q16, union16.T))
        n_live = int(idx.numel())
        b_ms, b_by = k5_bound(q_n, n_live, n_ch, DIM + 4, IVF_S, IVF_C)
        emit(kernel="K5", rows="int8", Q=q_n, union_clusters=int(nact[0]), chunks=n_ch,
             live_rows=n_live, ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        del union16, idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
