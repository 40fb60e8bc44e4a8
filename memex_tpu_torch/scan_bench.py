"""Bank-only times of the seven scans K1-K7 on one card, to compare two
checkouts of this repository in one call.

    python memex_tpu_torch/scan_bench.py [--root DIR] [--label NAME]
                                         [--kernels K1,K2,K3,K4,K5,K6,K7]
                                         [--queries 1,32,128]

Imports memex_tpu_torch from DIR (default: the checkout holding this file),
builds its kernels there, and times with CUDA events (median of 20 after 3
warm-up calls):
  - K1, `fused_score_bank_cuda`, on 1,048,576 x 384 float32 and bf16 unit
    rows, count = N - 12345, ~1% dead rows, keep2 off;
  - K2, `fused_score_bank_int8q_cuda`, on the int8 codes of the same rows,
    banks = 4 (S = 512, the flat index's width), int8 queries;
  - K3, `fused_score_bank_int8_cuda`, on the same codes with float32
    queries (rounded to bf16 in the kernel), banks = 8 (S = 1,024: the flat
    index's `query_quantize=False` call);
  - K4, `int4q_candidates_cuda`, on their packed int4 codes, banks = 8, in
    shift and in deferred mode: the wrapper's time (it makes the scan's
    query operands from the float32 queries first) and, as kernel_ms, the
    scan alone on operands prepared beforehand;
  - K5, `ivf_batch_bank_cuda`, on an int8 table of the 10M IVF
    configuration's shape (C = 4096 clusters, M = 3072, D = 384, S = 1024,
    bucket sizes uniform in [1536, 3072]), over the union that
    `route_union` gives random unit queries at nprobe = 64;
  - K6, `ivf_batch4_bank_cuda`, on the int4 row-pair mirror of that table
    (`pack_int4_buckets`, banks = 8), over the same unions;
  - K7, `ivf_probe_bank_cuda`, where the port runs it: an int8 table of 4
    clusters x 315,392 rows (the 1M-row, 4-cluster index's bucket; sizes
    summing to 1,048,576), each query's own 4 probes in routing order
    (S = 256); and on the 10M table with each query's own 64 probes, a
    shape off K7's path (IVFIndex._scan sends M = 3,072 to K5), kept as a
    yardstick across checkouts;
at Q = 1, 32 and 128 (or --queries). Beside each time it prints the bound (the larger of
the bytes the function must move at 3.35 TB/s and its products at the
card's tensor-core peak for the product's type, live rows only) and one
PyTorch call of the same function's product on operands laid out
beforehand (library_ms): `torch.matmul` of bf16 operands for K1, K3, K5
and K6 (K6: against the union's unpacked int4 codes) and for K7 on 4
clusters (against the probed union, which every query probes whole),
`torch._int_mm` of the int8 queries and codes for K2 and K4 (null where its
shape rules refuse the batch), `torch.bmm` of each query against its
probes' whole buckets for K7 on the 10M table. K7's partial banks (Q *
nprobe * R * S * 8 bytes, written and read once) are counted apart, in
bound_with_partials_ms: they are not the function's inputs or outputs. `--kernels KM` adds the sums of one k-means iteration at the 10M
build's shape (262,144 x 384 sample rows, 4,096 clusters): the fixed-order
`cluster_sums` beside `index_add_`, and whether two runs of each agree bit
for bit. One JSON line per measurement, with the card's
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
IVF_PROBE_S = 256  # K7's bank width
# K7's own shape: the smoke's 1M-row, 4-cluster index (bucket_factor 1.2).
FEW_C, FEW_M = 4, 315392
FEW_SIZES = (315392, 262144, 250000, 221040)  # 1,048,576 rows
OFF_PATH = "10M, off K7's path: IVFIndex._scan sends M = 3,072 to K5"
ALL_KERNELS = "K1,K2,K3,K4,K5,K6,K7"


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


def k3_bound(q_n: int, live: int, limit: int, n_slots: int) -> tuple[float, str]:
    """K3: K2's rows, scales and alive entries, float32 queries, the bank;
    2 * Q * D bf16 operations a row."""
    n_bytes = live * (DIM + 4) + limit * 4 + q_n * DIM * 4 + q_n * n_slots * 8
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16")


def k4_bound(q_n: int, live: int, limit: int, n_slots: int, deferred: bool) -> tuple[float, str]:
    """K4: live packed rows (D / 2 bytes) with their scales, the alive
    entries, the float32 queries, the bank; 2 * Q * D operations a row, int8
    in shift mode, 16-bit floats in deferred mode."""
    n_bytes = live * (DIM // 2 + 4) + limit * 4 + q_n * DIM * 4 + q_n * n_slots * 8
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16" if deferred else "int8")


def k6_bound(q_n: int, live_packed: int, live: int, n_chunks: int, n_slots: int,
             n_clusters: int) -> tuple[float, str]:
    """K6: the union's live packed rows (D bytes a row pair) and a scale for
    each live logical row, its walk and the bucket sizes, the queries, the
    bank; two dots a packed row, 2 * Q * D operations a logical row."""
    n_bytes = (live_packed * DIM + live * 4 + n_chunks * 4 + n_clusters * 4 + q_n * DIM * 4
               + q_n * n_slots * 8)
    return bound(n_bytes, 2.0 * q_n * live * DIM, "bf16")


def k7_bound(q_n: int, rows_read: int, rows_scored: int, n_probes: int, row_bytes: int,
             n_slots: int, n_clusters: int, extra_bytes: int = 0) -> tuple[float, str]:
    """K7: each probed bucket's live rows (and scales) read once, the probes
    and the bucket sizes, the queries, the bank; each query scores its own
    probes' rows, 2 * D operations each. `extra_bytes`: what a design moves
    besides (K7's partial banks)."""
    n_bytes = (rows_read * row_bytes + n_probes * 4 + n_clusters * 4 + q_n * DIM * 4
               + q_n * n_slots * 8 + extra_bytes)
    return bound(n_bytes, 2.0 * rows_scored * DIM, "bf16")


def k7_partial_bytes(isc, q_n: int, nprobe: int, n_clusters: int, m: int) -> int:
    """Bytes of K7's partial banks, written once and read once by its
    merge; 0 for a checkout whose K7 has none."""
    if not hasattr(isc, "probe_plan"):
        return 0
    ranges = isc.probe_plan(q_n, nprobe, n_clusters, m, IVF_PROBE_S)[2]
    return 2 * q_n * nprobe * ranges * IVF_PROBE_S * 8


def k7_emit(emit, isc, q_n, q, data, rscales, sizes, probes, lib_ms, shape):
    """Times K7 on these probes and emits it with its bounds."""
    import torch

    C, M, _ = data.shape
    ms = cuda_ms(lambda: isc.ivf_probe_bank_cuda(data, rscales, sizes, probes, q))
    scored = int(sizes.long()[probes.long()].sum())
    read = int(sizes.long()[torch.unique(probes.long())].sum())
    nprobe = probes.shape[1]
    args = (q_n, read, scored, probes.numel(), DIM + 4, IVF_PROBE_S, C)
    b_ms, b_by = k7_bound(*args)
    partial = k7_partial_bytes(isc, q_n, nprobe, C, M)
    emit(kernel="K7", rows="int8", shape=shape, Q=q_n, nprobe=nprobe, rows_read=read,
         rows_scored=scored, ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
         partial_bank_bytes=partial, bound_with_partials_ms=k7_bound(*args, partial)[0],
         **k7_list(isc, q_n, data, probes))


def k7_list(isc, q_n, data, probes) -> dict:
    """For a checkout whose K7 runs a work list: its plan and the list's
    build alone (list_ms; `ms` less it is the scan, the merge and the
    wrapper's host time)."""
    if not hasattr(isc, "probe_work_list"):
        return {}
    C, M, _ = data.shape
    T, n_tiles, R = isc.probe_plan(q_n, probes.shape[1], C, M, IVF_PROBE_S)
    list_ms = cuda_ms(lambda: isc.probe_work_list(probes, C, T, n_tiles))
    tiles = isc.probe_work_list(probes, C, T, n_tiles)[1]
    return dict(tile_q=T, ranges=R, tiles_bound=n_tiles, tiles=int((tiles[2] > 0).sum()),
                list_ms=list_ms)


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
    """(packed [N, D/2] int8 rows as the flat index stores them, from
    `quantize_rows_int4`: byte j = 16 * code[j + D/2] + code[j]; the int4
    codes [N, D] as int8, unpacked from those bytes, for the library's
    int8 product)."""
    import torch

    from memex_tpu_torch.ops.fused_topk import quantize_rows_int4

    packed, _ = quantize_rows_int4(rows)
    b = packed.to(torch.int32)
    lo = torch.remainder(b + 8, 16) - 8  # code[j] in [-7, 7]
    return packed, torch.cat([lo, (b - lo) // 16], dim=1).to(torch.int8)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default=ALL_KERNELS)
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
    if which & {"K2", "K3", "K4"}:
        codes, scales = ft.quantize_rows_int8(db32)
    if "K4" in which:
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
    if "K3" in which:
        codes16 = codes[:limit].to(torch.bfloat16)
    for q_n, q in queries.items() if "K3" in which else ():
        ms = cuda_ms(lambda: ft.fused_score_bank_int8_cuda(codes, scales, q, count=limit,
                                                           alive=alive, banks=8))
        q16 = q.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(q16, codes16.T))
        b_ms, b_by = k3_bound(q_n, live, limit, 1024)
        emit(kernel="K3", rows="int8", Q=q_n, n_rows=limit, live_rows=live, ms=ms,
             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    if "K3" in which:
        del codes16
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
    codes = scales = packed = c4 = alive = None
    torch.cuda.empty_cache()
    if "KM" in which:
        kmeans_sums(emit, gen, dev)
    if not which & {"K5", "K6", "K7"}:
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
    if "K6" in which:
        from memex_tpu_torch.ops import ivf_batch4 as ib4

        data4, rscales4 = ib4.pack_int4_buckets(data, rscales, banks=IVF_S // 128)
    for q_n, q in queries.items() if which & {"K5", "K6"} else ():
        clist, nact = ib.route_union(centroids, q, IVF_NPROBE)
        walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, IVF_S)
        n_ch = int(n_chunks[0])
        col, ok = ib._union_columns(walk, n_chunks, sizes, IVF_M, IVF_S)
        idx = col[ok]  # the union's live rows
        n_live = int(idx.numel())
        q16 = q.to(torch.bfloat16)
        common = dict(Q=q_n, union_clusters=int(nact[0]), chunks=n_ch, live_rows=n_live)
        if "K5" in which:
            ms = cuda_ms(lambda: ib.ivf_batch_bank_cuda(data, rscales, sizes, walk, n_chunks, q,
                                                        banks=IVF_S // 128))
            union16 = flat[idx].to(torch.bfloat16)
            lib_ms = cuda_ms(lambda: torch.matmul(q16, union16.T))
            b_ms, b_by = k5_bound(q_n, n_live, n_ch, DIM + 4, IVF_S, IVF_C)
            emit(kernel="K5", rows="int8", **common, ms=ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by)
            del union16
        if "K6" in which:
            ms = cuda_ms(lambda: ib4.ivf_batch4_bank_cuda(data4, rscales4, sizes, walk, n_chunks,
                                                          q, banks=IVF_S // 128))
            # The union's int4 codes, unpacked: what one matmul would read.
            union16 = torch.clamp((flat[idx].to(torch.int32) + 8) >> 4, -7, 7).to(torch.bfloat16)
            lib_ms = cuda_ms(lambda: torch.matmul(q16, union16.T))
            # A packed row is live with its first row: the first half of a chunk.
            live_packed = int(ok.view(n_ch, IVF_S)[:, : IVF_S // 2].sum())
            b_ms, b_by = k6_bound(q_n, live_packed, n_live, n_ch, IVF_S, IVF_C)
            emit(kernel="K6", rows="int4-pairs", **common, live_packed_rows=live_packed, ms=ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            del union16
        del idx, col, ok
        torch.cuda.empty_cache()
    if "K6" in which:
        del data4, rscales4
        torch.cuda.empty_cache()
    if "K7" not in which:
        return 0

    # K7 on the 10M table, each query with its own 64 probes.
    from memex_tpu_torch.index.ivf import _route
    from memex_tpu_torch.ops import ivf_scan as isc

    for q_n, q in queries.items():
        probes = _route(centroids, q, IVF_NPROBE).to(torch.int32)
        buckets = data[probes.long()].reshape(q_n, -1, DIM).to(torch.bfloat16)
        qb = q.to(torch.bfloat16)[:, None, :]
        lib_ms = cuda_ms(lambda: torch.bmm(qb, buckets.transpose(1, 2)))
        del buckets
        torch.cuda.empty_cache()
        k7_emit(emit, isc, q_n, q, data, rscales, sizes, probes, lib_ms, OFF_PATH)
    del data, rscales, sizes, flat
    torch.cuda.empty_cache()

    # K7 where the port runs it: 4 clusters, every query probing all 4.
    data = torch.randint(-127, 128, (FEW_C, FEW_M, DIM), generator=gen, device=dev,
                         dtype=torch.int8)
    rscales = torch.rand((FEW_C, FEW_M), generator=gen, device=dev) * 1e-2 + 1e-3
    sizes = torch.tensor(FEW_SIZES, dtype=torch.int32, device=dev)
    c = torch.randn((FEW_C, DIM), generator=gen, device=dev)
    centroids = c / c.norm(dim=1, keepdim=True)
    union16 = torch.cat([data[i, :n] for i, n in enumerate(FEW_SIZES)]).to(torch.bfloat16)
    for q_n, q in queries.items():
        probes = _route(centroids, q, FEW_C).to(torch.int32)
        q16 = q.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(q16, union16.T))
        k7_emit(emit, isc, q_n, q, data, rscales, sizes, probes, lib_ms,
                f"{FEW_C} clusters x {FEW_M:,} (K7's path)")
    return 0


def kmeans_sums(emit, gen, dev, n: int = IVF_C * 64, runs: int = 5) -> None:
    """One k-means iteration's per-cluster sums at the 10M build's shape:
    `cluster_sums` (fixed order) beside `index_add_` (float atomics)."""
    import torch

    from memex_tpu_torch.index import ivf

    if not hasattr(ivf, "cluster_sums"):
        print("this checkout's k-means sums with index_add_ only", flush=True)
        return
    x = torch.randn((n, DIM), generator=gen, device=dev)
    rows = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16).float()
    c = torch.randn((IVF_C, DIM), generator=gen, device=dev)
    assign = ivf.kmeans_assign(rows, c / c.norm(dim=1, keepdim=True))

    def atomics():
        return torch.zeros((IVF_C, DIM), device=dev).index_add_(0, assign, rows)

    def fixed():
        return ivf.cluster_sums(rows, assign, IVF_C)

    emit(kernel="kmeans_sums", rows=n, clusters=IVF_C,
         ms=cuda_ms(fixed, runs=runs, warmup=1), index_add_ms=cuda_ms(atomics, runs=runs, warmup=1),
         assign_ms=cuda_ms(lambda: ivf.kmeans_assign(rows, c), runs=runs, warmup=1),
         bit_equal_runs=all(torch.equal(fixed(), fixed()) for _ in range(3)),
         index_add_bit_equal_runs=all(torch.equal(atomics(), atomics()) for _ in range(3)),
         max_abs_diff=(fixed() - atomics()).abs().max().item())


if __name__ == "__main__":
    sys.exit(main())
