"""The CUDA kernels (memex_tpu_torch/csrc/fused_topk*.cu: K1-K4; ivf_*.cu:
K5-K7) against their plain PyTorch versions on the card, and k-means'
determinism there. Marked `gpu`: without a CUDA
card every test here skips. Run on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from memex_tpu_torch.index.flat import FlatIndex
from memex_tpu_torch.ops import fused_topk as ft

pytestmark = pytest.mark.gpu

N, D = 1 << 16, 384
# K1 and K3: kernel and plain version sum 384 float32 products in
# different orders: float32 ulps of a score <= 1. K2 and K4 are exact
# integer dots and must match bit for bit (torch.equal).
SCORE_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(gen, n, device):
    x = torch.randn((n, D), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def _check_near_ties(kv, ki, pv, pi, score_of):
    """Values within SCORE_TOL; an index may differ only at a near-tie,
    where the kernel's row must score what the kernel reports."""
    assert (kv - pv).abs().max().item() <= SCORE_TOL
    diff = ki != pi
    if diff.any():
        qi, pos = torch.nonzero(diff, as_tuple=True)
        assert (score_of(qi, ki[qi, pos].long()) - kv[qi, pos]).abs().max().item() <= SCORE_TOL


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("exact,keep2", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, exact, keep2, q_n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    db = _unit(gen, N, cuda).to(dtype)
    q = _unit(gen, q_n, cuda)
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    kw = dict(count=N - 1234, alive=alive, exact=exact, keep2=keep2)
    before = ft.LAUNCHES["fused_topk"]
    kv, ki = ft.fused_score_topk(db, q, 128, **kw)
    assert ft.LAUNCHES["fused_topk"] == before + 1
    pv, pi = ft.fused_score_topk_reference(db, q, 128, **kw)
    torch.cuda.synchronize()
    full = exact and dtype == torch.float32

    def score_of(qi, rows):
        qq = q[qi] if full else q[qi].bfloat16().float()
        rr = db[rows].float() if full else db[rows].bfloat16().float()
        return (qq * rr).sum(1)

    _check_near_ties(kv, ki, pv, pi, score_of)
    assert int(ki.max()) < N - 1234
    assert (alive[ki.long()] > 0).all()


def _int8_corpus(cuda, seed=1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    codes, scales = ft.quantize_rows_int8(_unit(gen, N, cuda))
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    return gen, codes, scales, alive


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("keep2", [False, True])
def test_int8q_kernel_is_bit_equal_to_plain(cuda, keep2, q_n):
    gen, codes, scales, alive = _int8_corpus(cuda)
    q = _unit(gen, q_n, cuda)
    q8, _ = ft.quantize_rows_int8(q)
    kw = dict(count=N - 1234, alive=alive, banks=4, keep2=keep2)
    bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw)
    plain = ft.int8q_bank_reference(codes, scales, q8, **kw)
    torch.cuda.synchronize()
    for a, b in zip(bank[0] + bank[1], plain[0] + plain[1], strict=True):
        assert torch.equal(a, b)
    before = ft.LAUNCHES["fused_topk_int8q"]
    kv, ki = ft.fused_score_topk_int8q(codes, scales, q, 128, **kw)
    assert ft.LAUNCHES["fused_topk_int8q"] == before + 1
    pv, pi = ft.fused_score_topk_int8q_reference(codes, scales, q, 128, **kw)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert int(ki.max()) < N - 1234 and (alive[ki.long()] > 0).all()


@pytest.mark.parametrize("q_n", [1, 32, 77])
def test_int8_kernel_matches_plain(cuda, q_n):
    gen, codes, scales, alive = _int8_corpus(cuda, seed=2)
    q = _unit(gen, q_n, cuda)
    kw = dict(count=N - 1234, alive=alive, banks=8)
    before = ft.LAUNCHES["fused_topk_int8"]
    kv, ki = ft.fused_score_topk_int8(codes, scales, q, 128, **kw)
    assert ft.LAUNCHES["fused_topk_int8"] == before + 1
    pv, pi = ft.fused_score_topk_int8_reference(codes, scales, q, 128, **kw)
    torch.cuda.synchronize()

    def score_of(qi, rows):
        return (q[qi].bfloat16().float() * codes[rows].float()).sum(1) * scales[rows]

    _check_near_ties(kv, ki, pv, pi, score_of)
    assert int(ki.max()) < N - 1234 and (alive[ki.long()] > 0).all()


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("keep2,banks", [(False, 8), (True, 16)])
@pytest.mark.parametrize("deferred", [False, True])
def test_int4q_kernel_is_bit_equal_to_plain(cuda, deferred, keep2, banks, q_n):
    """Both unpack modes are exact integer dots below 2^24 at D = 384."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    packed, _ = ft.np_quantize_rows_int4(x)
    codes, scales = ft.quantize_rows_int8(torch.from_numpy(x))
    db_p, codes, scales = (t.to(cuda) for t in (torch.from_numpy(packed), codes, scales))
    alive = (torch.from_numpy(rng.random(N)).to(cuda) > 0.05).float()
    q = torch.from_numpy(x[rng.choice(N, q_n)]).to(cuda)
    kw = dict(count=N - 1234, alive=alive, banks=banks, deferred=deferred, keep2=keep2)
    before = ft.LAUNCHES["fused_topk_int4q"]
    bank = ft.int4q_candidates(db_p, scales, q, **kw)
    assert ft.LAUNCHES["fused_topk_int4q"] == before + 1
    plain = ft.int4q_candidates_reference(db_p, scales, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bank[0], plain[0]) and torch.equal(bank[1], plain[1])
    kv, ki = ft.fused_score_topk_int4_rerank(db_p, scales, codes, q, 10, **kw)
    pv, pi = ft.fused_score_topk_int4_rerank_reference(db_p, scales, codes, q, 10, **kw)
    _check_near_ties(kv, ki, pv, pi, lambda qi, rows: (
        q[qi].bfloat16().float() * codes[rows].float()).sum(1) * scales[rows])


def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((2, 512), device=cuda)
    with pytest.raises(ValueError):
        ft.fused_score_topk(torch.zeros((4096, 512), device=cuda), q, 4)
    with pytest.raises(ValueError):
        ft.fused_score_topk(torch.zeros((384, 4096), device=cuda).T, q[:, :384], 4)
    scales = torch.ones(4096, device=cuda)
    for d in (376, 512):  # not a multiple of 16 bytes / too wide
        codes = torch.zeros((4096, d), dtype=torch.int8, device=cuda)
        with pytest.raises(ValueError):
            ft.fused_score_topk_int8q(codes, scales, torch.zeros((2, d), device=cuda), 4)
        with pytest.raises(ValueError):
            ft.fused_score_topk_int8(codes, scales, torch.zeros((2, d), device=cuda), 4)
    packed = torch.zeros((4096, 184), dtype=torch.int8, device=cuda)  # d = 368: not d % 32
    with pytest.raises(ValueError):
        ft.int4q_candidates(packed, scales, torch.zeros((2, 368), device=cuda))


@pytest.mark.parametrize("tier,kernel", [
    (dict(), "fused_topk"),
    (dict(dtype="int8", refine=True), "fused_topk_int8q"),
    (dict(dtype="int8", query_quantize=False), "fused_topk_int8"),
    (dict(dtype="int4"), "fused_topk_int4q"),
], ids=["float32", "int8-refine", "int8-bf16-queries", "int4"])
def test_flat_index_on_the_card_matches_cpu(cuda, tier, kernel):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5000, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"v{i}" for i in range(5000)]
    gpu = FlatIndex(D, device=cuda, **tier)
    cpu = FlatIndex(D, device="cpu", use_fused=True, **tier)
    assert gpu.use_fused
    for idx in (gpu, cpu):
        idx.add(vecs, ids)
        idx.delete(ids[:40])
    q = vecs[100:108]
    before = ft.LAUNCHES[kernel]
    hg, hc = gpu.search(q, 10), cpu.search(q, 10)
    assert ft.LAUNCHES[kernel] > before
    for a, b in zip(hg, hc):
        assert [s for s, _ in a] == [s for s, _ in b]
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b], atol=SCORE_TOL)


# -- K1's tensor-core body (more than one query, non-exact modes) --

# Query counts around the body's edges: a 16-query n-tile pair, a 32-query
# fold pass, the 128-query tile and a second tile.
TC_Q = [2, 8, 31, 32, 33, 128, 256]


def _duplicate_heavy(gen, n, device, distinct=2048):
    """n unit rows drawn from `distinct` rows: exact ties everywhere."""
    pool = _unit(gen, distinct, device)
    return pool[torch.randint(0, distinct, (n,), generator=gen, device=device)]


@pytest.mark.parametrize("q_n", TC_Q)
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k1_tensor_core_body_matches_plain(cuda, corpus, dtype, keep2, q_n):
    """count = N - 1234 leaves each slot 62 or 63 steps: the last group of
    16 is ragged; ~5% dead rows."""
    gen = torch.Generator(device=cuda).manual_seed(q_n)
    rows = _unit(gen, N, cuda) if corpus == "random" else _duplicate_heavy(gen, N, cuda)
    db = rows.to(dtype)
    q = _unit(gen, q_n, cuda)
    if corpus == "duplicates":
        q[: q_n // 2] = rows[: q_n // 2]  # queries that tie their duplicates exactly
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    kw = dict(count=N - 1234, alive=alive, keep2=keep2)
    before = ft.LAUNCHES["fused_topk"]
    bank = ft.fused_score_bank_cuda(db, q, **kw)
    assert ft.LAUNCHES["fused_topk"] == before + 1
    plain = ft._fold_bank(ft.scores_f32(q, db[: N - 1234].T, False), alive, 1024, keep2)
    torch.cuda.synchronize()

    def score_of(qi, idx):
        return (q[qi].bfloat16().float() * db[idx].bfloat16().float()).sum(1)

    _bank_check(bank, plain, score_of)
    kv, ki = ft.fused_score_topk(db, q, 64, **kw)
    pv, pi = ft.fused_score_topk_reference(db, q, 64, **kw)
    _check_near_ties(kv, ki, pv, pi, lambda qi, rows_: score_of(qi, rows_))
    assert (alive[ki.long()] > 0).all() and int(ki.max()) < N - 1234


# -- K2's and K4's tensor-core body (more than one query) --


def _rows_of(gen, corpus, n, d, device):
    """n unit rows of width d, random or drawn from 2,048 distinct ones."""
    m = n if corpus == "random" else 2048
    x = torch.randn((m, d), generator=gen, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    if corpus == "duplicates":
        x = x[torch.randint(0, m, (n,), generator=gen, device=device)]
    return x


def _tied_queries(gen, corpus, rows, q_n):
    q = _rows_of(gen, "random", q_n, rows.shape[1], rows.device)
    if corpus == "duplicates":
        q[: q_n // 2] = rows[: q_n // 2]  # queries that tie their duplicates exactly
    return q


@pytest.mark.parametrize("q_n", TC_Q)
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("d", [384, 48])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k2_tensor_core_body_is_bit_equal_to_plain(cuda, corpus, d, keep2, q_n):
    """The s8 product is exact, so the bank is the plain version's bit for
    bit, ties included. count = N - 1234 is no multiple of a block's 4
    slots and leaves the last group of 16 steps ragged; d = 48 is a
    multiple of 16 but not of the product's k = 32."""
    gen = torch.Generator(device=cuda).manual_seed(q_n)
    rows = _rows_of(gen, corpus, N, d, cuda)
    codes, scales = ft.quantize_rows_int8(rows)
    q8, _ = ft.quantize_rows_int8(_tied_queries(gen, corpus, rows, q_n))
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    kw = dict(count=N - 1234, alive=alive, banks=4, keep2=keep2)
    before = ft.LAUNCHES["fused_topk_int8q"]
    bank = ft.fused_score_bank_int8q_cuda(codes, scales, q8, **kw)
    assert ft.LAUNCHES["fused_topk_int8q"] == before + 1
    plain = ft.int8q_bank_reference(codes, scales, q8, **kw)
    torch.cuda.synchronize()
    for a, b in zip(bank[0] + bank[1], plain[0] + plain[1], strict=True):
        assert torch.equal(a, b)
    no_mask = ft.fused_score_bank_int8q_cuda(codes, scales, q8, banks=8, keep2=keep2)
    plain = ft.int8q_bank_reference(codes, scales, q8, banks=8, keep2=keep2)
    for a, b in zip(no_mask[0] + no_mask[1], plain[0] + plain[1], strict=True):
        assert torch.equal(a, b)


def _pack_int4(rows):
    """Packed int4 rows [N, d/2] (byte j = 16 * code[j + d/2] + code[j])."""
    d = rows.shape[1]
    s4 = torch.clamp(rows.abs().amax(dim=1), min=1e-12) / 7.0
    c4 = torch.clamp(torch.round(rows / s4[:, None]), -7, 7).to(torch.int32)
    return (c4[:, : d // 2] + 16 * c4[:, d // 2 :]).to(torch.int8).contiguous()


@pytest.mark.parametrize("q_n", TC_Q)
@pytest.mark.parametrize("keep2,banks", [(False, 8), (True, 16)])
@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("d", [384, 96])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k4_tensor_core_body_is_bit_equal_to_plain(cuda, corpus, d, deferred, keep2, banks, q_n):
    """Both modes are exact integer dots below 2^24: shift on the s8
    product, deferred on the f16 one. d = 96 packs to 48 bytes a row, a
    multiple of 16 but not of the s8 product's k = 32."""
    gen = torch.Generator(device=cuda).manual_seed(100 + q_n)
    rows = _rows_of(gen, corpus, N, d, cuda)
    packed = _pack_int4(rows)
    _, scales = ft.quantize_rows_int8(rows)
    q = _tied_queries(gen, corpus, rows, q_n)
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    kw = dict(count=N - 1234, alive=alive, banks=banks, deferred=deferred, keep2=keep2)
    before = ft.LAUNCHES["fused_topk_int4q"]
    bank = ft.int4q_candidates_cuda(packed, scales, q, **kw)
    assert ft.LAUNCHES["fused_topk_int4q"] == before + 1
    plain = ft.int4q_candidates_reference(packed, scales, q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bank[0], plain[0]) and torch.equal(bank[1], plain[1])
    live = bank[0] > -1e29
    assert (alive[bank[1].long()] > 0)[live].all() and int(bank[1].max()) < N - 1234


@pytest.mark.parametrize("q_n", [1, 33])
@pytest.mark.parametrize("d", [384, 96])
@pytest.mark.parametrize("deferred", [False, True])
def test_k4_query_operand_kernel_is_bit_equal_to_plain(cuda, deferred, d, q_n):
    """The one-launch query quantization of K4's wrapper gives the plain
    version's operands bit for bit: same float32 scale, same round-half-even
    codes, same bf16 rounding of in2, also for a zero query, a huge one, and
    values on rounding ties (multiples of half a quantization step)."""
    gen = torch.Generator(device=cuda).manual_seed(7 * q_n + d)
    q = torch.randn((q_n + 3, d), generator=gen, device=cuda)
    q[-3] = 0.0
    q[-2] *= 1e30
    q[-1] = torch.randint(-254, 255, (d,), generator=gen, device=cuda).float() * 0.5
    q[-1, 0] = 127.0
    got = ft.int4_query_operands_cuda(q, deferred)
    want = ft._int4_query_operands(q, deferred)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the IVF scans: K5 (csrc/ivf_batch.cu), K6 (ivf_batch4.cu), K7 (ivf_scan.cu) --

IVF_C, IVF_M = 64, 2048


def _ivf_table(cuda, seed=4):
    """Ragged buckets with empty and full clusters, and a routed union."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    sizes = torch.randint(0, IVF_M + 1, (IVF_C,), generator=gen, device=cuda).to(torch.int32)
    sizes[:3] = 0
    sizes[3] = IVF_M
    sizes[4] = 1025
    rows = _unit(gen, IVF_C * IVF_M, cuda).reshape(IVF_C, IVF_M, D)
    centroids = _unit(gen, IVF_C, cuda)
    return gen, sizes, rows, centroids


def _bank_check(bank, plain, score_of):
    """Bank values within SCORE_TOL slot by slot; an index may differ only
    where the kernel's row scores what the kernel holds (a near-tie)."""
    for kv, ki, pv, pi in zip(bank[0], bank[1], plain[0], plain[1], strict=True):
        assert (kv - pv).abs().max().item() <= SCORE_TOL
        live = kv > -1e29
        assert torch.equal(live, pv > -1e29)
        diff = live & (ki != pi)
        if diff.any():
            qi, slot = torch.nonzero(diff, as_tuple=True)
            got = score_of(qi, ki[qi, slot].long())
            assert (got - kv[qi, slot]).abs().max().item() <= SCORE_TOL


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("dtype,exact", [("float32", False), ("float32", True),
                                         ("bfloat16", False), ("int8", False)])
@pytest.mark.parametrize("banks", [4, 8])
def test_ivf_batch_kernel_matches_plain(cuda, banks, dtype, exact, keep2, q_n):
    from memex_tpu_torch.ops import ivf_batch as ib

    gen, sizes, rows, centroids = _ivf_table(cuda)
    if dtype == "int8":
        codes, sc = ft.quantize_rows_int8(rows.reshape(-1, D))
        data, rscales = codes.reshape(IVF_C, IVF_M, D), sc.reshape(IVF_C, IVF_M)
    else:
        data = rows.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        rscales = torch.ones((IVF_C, IVF_M), device=cuda)
    q = _unit(gen, q_n, cuda)
    clist, nact = ib.route_union(centroids, q, 24)
    walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, banks * 128)
    kw = dict(banks=banks, exact=exact, keep2=keep2)
    before = ft.LAUNCHES["ivf_batch"]
    bank = ib.ivf_batch_bank_cuda(data, rscales, sizes, walk, n_chunks, q, **kw)
    assert ft.LAUNCHES["ivf_batch"] == before + 1
    plain = ib.ivf_batch_bank_reference(data, rscales, sizes, walk, n_chunks, q, **kw)
    torch.cuda.synchronize()
    full = exact and dtype == "float32"

    def score_of(qi, idx):
        qq = q[qi] if full else q[qi].bfloat16().float()
        rr = data.reshape(-1, D)[idx].float()
        if not full:
            rr = rr.bfloat16().float()
        return (qq * rr).sum(1) * rscales.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)
    ki = torch.cat(bank[1], dim=1).long()
    live = torch.cat(bank[0], dim=1) > -1e29
    assert ((ki % IVF_M) < sizes[ki // IVF_M])[live].all()


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("keep2", [False, True])
def test_ivf_batch4_kernel_matches_plain(cuda, keep2, q_n):
    from memex_tpu_torch.ops import ivf_batch as ib
    from memex_tpu_torch.ops import ivf_batch4 as ib4

    gen, sizes, rows, centroids = _ivf_table(cuda, seed=5)
    codes, sc = ft.quantize_rows_int8(rows.reshape(-1, D))
    codes, sc = codes.reshape(IVF_C, IVF_M, D), sc.reshape(IVF_C, IVF_M)
    data4, rscales4 = ib4.pack_int4_buckets(codes, sc, banks=8)
    q = _unit(gen, q_n, cuda)
    clist, nact = ib.route_union(centroids, q, 24)
    walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, 1024)
    before = ft.LAUNCHES["ivf_batch4"]
    bank = ib4.ivf_batch4_bank_cuda(data4, rscales4, sizes, walk, n_chunks, q, banks=8,
                                    keep2=keep2)
    assert ft.LAUNCHES["ivf_batch4"] == before + 1
    plain = ib4.ivf_batch4_bank_reference(data4, rscales4, sizes, walk, n_chunks, q, banks=8,
                                          keep2=keep2)
    torch.cuda.synchronize()
    hi4 = torch.clamp((codes.reshape(-1, D).to(torch.int32) + 8) >> 4, -7, 7).float()

    def score_of(qi, idx):
        return (q[qi].bfloat16().float() * hi4[idx]).sum(1) * rscales4.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)
    vals, cl, sl = ib4.ivf_batch_search4(centroids, data4, rscales4, codes, sc, sizes, q, 24,
                                         10, banks=8, keep2=keep2)
    assert ((sl < sizes[cl.long()]) | (vals <= -1e29)).all()


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ivf_probe_kernel_matches_plain(cuda, dtype, q_n):
    from memex_tpu_torch.index.ivf import _route
    from memex_tpu_torch.ops import ivf_scan as isc

    gen, sizes, rows, centroids = _ivf_table(cuda, seed=6)
    if dtype == "int8":
        codes, sc = ft.quantize_rows_int8(rows.reshape(-1, D))
        data, rscales = codes.reshape(IVF_C, IVF_M, D), sc.reshape(IVF_C, IVF_M)
    else:
        data = rows.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        rscales = torch.ones((IVF_C, IVF_M), device=cuda)
    q = _unit(gen, q_n, cuda)
    probes = _route(centroids, q, 8).to(torch.int32)
    before = ft.LAUNCHES["ivf_probe"]
    bank = isc.ivf_probe_bank_cuda(data, rscales, sizes, probes, q)
    assert ft.LAUNCHES["ivf_probe"] == before + 1
    plain = isc.ivf_probe_bank_reference(data, rscales, sizes, probes, q)
    torch.cuda.synchronize()

    def score_of(qi, idx):
        rr = data.reshape(-1, D)[idx].float().bfloat16().float()
        return (q[qi].bfloat16().float() * rr).sum(1) * rscales.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)
    ki = bank[1][0].long()
    live = bank[0][0] > -1e29
    own = (ki // IVF_M)[:, :, None] == probes.long()[:, None, :]
    assert own.any(dim=2)[live].all()  # only the query's own probes


@pytest.mark.parametrize("tier,kernel", [
    (dict(dtype="float32"), "ivf_batch"),
    (dict(dtype="float32", scan_precision="highest"), "ivf_batch"),
    (dict(dtype="int8", refine=True), "ivf_batch"),
    (dict(dtype="int8", scan_int4=True), "ivf_batch4"),
], ids=["float32", "float32-highest", "int8-refine", "int8-int4"])
def test_ivf_index_on_the_card_matches_cpu(cuda, tier, kernel):
    """The CPU index's table installed on the card: the kernels' hits are
    the plain versions'."""
    from memex_tpu_torch.index.ivf import IVFIndex, ivf_state_from_numpy

    rng = np.random.default_rng(1)
    topics = rng.standard_normal((64, D)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    # cos(row, topic) ~ 0.8 (bench.py's IVF corpus): neighbours' scores
    # spread well past float32 noise.
    vecs = topics[rng.integers(0, 64, 20000)] + 0.75 / D ** 0.5 * rng.standard_normal(
        (20000, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"v{i}" for i in range(len(vecs))]
    cpu = IVFIndex(D, n_clusters=32, nprobe=6, device="cpu", use_fused=True, **tier)
    cpu.build(vecs, ids)
    cpu.delete(ids[:30])
    gpu = IVFIndex(D, n_clusters=32, nprobe=6, device=cuda, **tier)
    assert gpu.use_fused
    arrs = {name: getattr(cpu, name) for name in ("centroids", "rscales", "sizes", "resid",
                                                    "resid_scales")}
    arrs = {name: None if t is None else t.numpy() for name, t in arrs.items()}
    ivf_state_from_numpy(gpu, data=cpu.data.float().numpy(), rowids=cpu.rowids, ids=cpu.ids,
                         mean=cpu.mean, **arrs)
    gpu.delete(ids[:30])
    q = vecs[100:132]
    before = ft.LAUNCHES[kernel]
    hg, hc = gpu.search(q, 10), cpu.search(q, 10)
    assert ft.LAUNCHES[kernel] == before + 1
    # Ids may swap only among near-ties.
    for a, b in zip(hg, hc):
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b], atol=SCORE_TOL)
        cpu_score = dict(b)
        for (sa, va), (sb, _) in zip(a, b):
            if sa != sb:
                assert abs(cpu_score.get(sa, b[-1][1]) - va) <= 2 * SCORE_TOL


@pytest.mark.parametrize("q_n", TC_Q)
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k5_tensor_core_body_matches_plain(cuda, corpus, dtype, keep2, q_n):
    """K5's int8, bf16 and bf16-rounded float32 bodies on ragged buckets,
    with a walk whose length is not a multiple of 16."""
    from memex_tpu_torch.ops import ivf_batch as ib

    gen, sizes, rows, centroids = _ivf_table(cuda, seed=7 + q_n)
    if corpus == "duplicates":
        rows = _duplicate_heavy(gen, IVF_C * IVF_M, cuda).reshape(IVF_C, IVF_M, D)
    if dtype == "int8":
        codes, sc = ft.quantize_rows_int8(rows.reshape(-1, D))
        data, rscales = codes.reshape(IVF_C, IVF_M, D), sc.reshape(IVF_C, IVF_M)
    else:
        data = rows.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        rscales = torch.ones((IVF_C, IVF_M), device=cuda)
    q = _unit(gen, q_n, cuda)
    if corpus == "duplicates":
        q[: q_n // 2] = rows.reshape(-1, D)[: q_n // 2]
    clist, nact = ib.route_union(centroids, q, 24)
    walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, 1024)
    if int(n_chunks[0]) % 16 == 0:
        n_chunks = n_chunks - 1  # a prefix of the walk is a walk
    assert int(n_chunks[0]) % 16 != 0
    kw = dict(banks=8, keep2=keep2)
    before = ft.LAUNCHES["ivf_batch"]
    bank = ib.ivf_batch_bank_cuda(data, rscales, sizes, walk, n_chunks, q, **kw)
    assert ft.LAUNCHES["ivf_batch"] == before + 1
    plain = ib.ivf_batch_bank_reference(data, rscales, sizes, walk, n_chunks, q, **kw)
    torch.cuda.synchronize()

    def score_of(qi, idx):
        rr = data.reshape(-1, D)[idx].float().bfloat16().float()
        return (q[qi].bfloat16().float() * rr).sum(1) * rscales.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)


# -- K3's and K6's tensor-core bodies --


@pytest.mark.parametrize("q_n", [1] + TC_Q)
@pytest.mark.parametrize("d,banks", [(384, 8), (48, 8), (384, 4), (384, 1)])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k3_tensor_core_body_matches_plain(cuda, corpus, d, banks, q_n):
    """K3 (bf16 queries, int8 rows) on the body at every batch size, a lone
    query included. The tensor cores sum the d products in another order
    than the plain version's matmul: values within SCORE_TOL, an index may
    differ only at a near-tie. count = N - 1234 is no multiple of a block's
    8 slots and leaves the last group of steps ragged; ~5% dead rows."""
    gen = torch.Generator(device=cuda).manual_seed(q_n)
    rows = _rows_of(gen, corpus, N, d, cuda)
    codes, scales = ft.quantize_rows_int8(rows)
    q = _tied_queries(gen, corpus, rows, q_n)
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()

    def score_of(qi, idx):
        return (q[qi].bfloat16().float() * codes[idx].float()).sum(1) * scales[idx]

    for kw in (dict(count=N - 1234, alive=alive, banks=banks), dict(banks=banks)):
        before = ft.LAUNCHES["fused_topk_int8"]
        bank = ft.fused_score_bank_int8_cuda(codes, scales, q, **kw)
        assert ft.LAUNCHES["fused_topk_int8"] == before + 1
        plain = ft.int8_bank_reference(codes, scales, q, **kw)
        torch.cuda.synchronize()
        _bank_check(bank, plain, score_of)
    ki = bank[1][0].long()
    assert (ki % (banks * 128) == torch.arange(banks * 128, device=cuda)[None, :]).all()


def _pair_table(gen, corpus, d, cuda):
    """An int8 bucket table [IVF_C, IVF_M, d] with ragged buckets: empty and
    full ones, and sizes that end on a chunk's first row, inside the first
    half of a chunk (on and off a block's edge) and inside its second."""
    sizes = torch.randint(0, IVF_M + 1, (IVF_C,), generator=gen, device=cuda).to(torch.int32)
    sizes[:3] = 0
    sizes[3:8] = torch.tensor([IVF_M, 1025, 1024 + 300, 1024 + 301, 1024 + 512 + 3],
                              dtype=torch.int32, device=cuda)
    rows = _rows_of(gen, corpus, IVF_C * IVF_M, d, cuda)
    codes, sc = ft.quantize_rows_int8(rows)
    x = torch.randn((IVF_C, d), generator=gen, device=cuda)
    return (sizes, rows, codes.reshape(IVF_C, IVF_M, d), sc.reshape(IVF_C, IVF_M),
            x / x.norm(dim=1, keepdim=True))


@pytest.mark.parametrize("q_n", [1] + TC_Q)
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("d,banks", [(384, 8), (384, 4), (96, 8)])
@pytest.mark.parametrize("corpus", ["random", "duplicates"])
def test_k6_tensor_core_body_matches_plain(cuda, corpus, d, banks, keep2, q_n):
    """K6 (row-pair packed int4, two folds a step) on the body, with a walk
    whose length is not a multiple of 16."""
    from memex_tpu_torch.ops import ivf_batch as ib
    from memex_tpu_torch.ops import ivf_batch4 as ib4

    gen = torch.Generator(device=cuda).manual_seed(11 + q_n)
    sizes, rows, codes, sc, centroids = _pair_table(gen, corpus, d, cuda)
    data4, rscales4 = ib4.pack_int4_buckets(codes, sc, banks=banks)
    q = _tied_queries(gen, corpus, rows, q_n)
    clist, nact = ib.route_union(centroids, q, 24)
    # The union as clusters 0 .. n - 1: the ragged buckets are among them.
    nact = torch.clamp(nact, min=8)
    clist[: int(nact[0])] = torch.arange(int(nact[0]), device=cuda, dtype=clist.dtype)
    walk, n_chunks = ib._chunk_walk(sizes, clist, nact, IVF_M, banks * 128)
    if int(n_chunks[0]) % 16 == 0:
        n_chunks = n_chunks - 1  # a prefix of the walk is a walk
    assert int(n_chunks[0]) % 16 != 0
    args = (data4, rscales4, sizes, walk, n_chunks, q)
    before = ft.LAUNCHES["ivf_batch4"]
    bank = ib4.ivf_batch4_bank_cuda(*args, banks=banks, keep2=keep2)
    assert ft.LAUNCHES["ivf_batch4"] == before + 1
    plain = ib4.ivf_batch4_bank_reference(*args, banks=banks, keep2=keep2)
    torch.cuda.synchronize()
    hi4 = torch.clamp((codes.reshape(-1, d).to(torch.int32) + 8) >> 4, -7, 7).float()

    def score_of(qi, idx):
        return (q[qi].bfloat16().float() * hi4[idx]).sum(1) * rscales4.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)
    for ki, kv in zip(bank[1], bank[0]):
        ki, live = ki.long(), kv > -1e29
        assert ((ki % IVF_M) < sizes[ki // IVF_M])[live].all()
        slot = torch.arange(banks * 128, device=cuda)[None, :].expand_as(ki)
        assert ((ki % (banks * 128)) == slot)[live].all()


@pytest.mark.parametrize("q_n", [1, 2, 32, 128])
def test_k6_unpacks_every_byte_value(cuda, q_n):
    """The index only packs codes in [-7, 7] (bytes in [-119, 119]); the
    kernel's byte-parallel hi = (b + 8) >> 4 and its b agree with the plain
    version's int32 arithmetic for all 256 byte values, b + 8 crossing zero
    and the bytes past 119 included."""
    from memex_tpu_torch.ops import ivf_batch as ib
    from memex_tpu_torch.ops import ivf_batch4 as ib4

    gen = torch.Generator(device=cuda).manual_seed(q_n)
    n_c, m = 4, 2048
    data4 = torch.randint(-128, 128, (n_c, m // 2, D), generator=gen, device=cuda,
                          dtype=torch.int8)
    data4[0, 0, :256] = torch.arange(-128, 128, device=cuda).to(torch.int8)
    assert torch.unique(data4).numel() == 256
    # |q . b| reaches a few hundred: scales that bring scores to order 0.1.
    rscales4 = torch.rand((n_c, m), generator=gen, device=cuda) * 1e-3 + 1e-4
    sizes = torch.tensor([m, m - 700, 1500, m], dtype=torch.int32, device=cuda)
    q = _unit(gen, q_n, cuda)
    clist = torch.arange(n_c, device=cuda, dtype=torch.int32)
    nact = torch.tensor([n_c], device=cuda, dtype=torch.int32)
    walk, n_chunks = ib._chunk_walk(sizes, clist, nact, m, 1024)
    args = (data4, rscales4, sizes, walk, n_chunks, q)
    bank = ib4.ivf_batch4_bank_cuda(*args, banks=8, keep2=True)
    plain = ib4.ivf_batch4_bank_reference(*args, banks=8, keep2=True)
    torch.cuda.synchronize()
    # Logical row j * S + s is the hi part of packed row j * S/2 + s, row
    # j * S + S/2 + s its b - 16 hi.
    b = data4.to(torch.int32).reshape(n_c, m // 1024, 512, D)
    hi = (b + 8) >> 4
    logical = torch.cat([hi, b - 16 * hi], dim=2).reshape(n_c * m, D).float()

    def score_of(qi, idx):
        return (q[qi].bfloat16().float() * logical[idx]).sum(1) * rscales4.reshape(-1)[idx]

    _bank_check(bank, plain, score_of)


def test_kmeans_on_the_card_is_a_function_of_its_seed(cuda):
    """Two fits of the same rows from one seed give bit-equal centroids
    (the cluster sums run in a fixed order, not through float atomics), and
    the sums agree with index_add_'s within float32 rounding."""
    from memex_tpu_torch.index import ivf

    gen = torch.Generator(device=cuda).manual_seed(3)
    rows = _unit(gen, 1 << 17, cuda)
    a = ivf.kmeans_fit(rows, 256, iters=4, seed=9)
    b = ivf.kmeans_fit(rows, 256, iters=4, seed=9)
    assert torch.equal(a, b)
    assert not torch.equal(a, ivf.kmeans_fit(rows, 256, iters=4, seed=10))
    assign = ivf.kmeans_assign(rows, a)
    v16 = rows.bfloat16().float()
    fixed = ivf.cluster_sums(v16, assign, 256, block=1 << 15)
    assert torch.equal(fixed, ivf.cluster_sums(v16, assign, 256, block=1 << 15))
    atomics = torch.zeros((256, D), device=cuda).index_add_(0, assign, v16)
    torch.testing.assert_close(fixed, atomics, rtol=1e-5, atol=1e-5)
