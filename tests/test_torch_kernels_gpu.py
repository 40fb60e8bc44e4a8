"""The CUDA kernel (K1, memex_tpu_torch/csrc/fused_topk.cu) against its
plain PyTorch version on the card. Marked `gpu`: without a CUDA card every
test here skips. Run on a card with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from memex_tpu_torch.index.flat import FlatIndex
from memex_tpu_torch.ops import fused_topk as ft

pytestmark = pytest.mark.gpu

N, D = 1 << 16, 384
# Kernel and plain version sum 384 float32 products in different orders:
# float32 ulps of a score <= 1.
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


@pytest.mark.parametrize("q_n", [1, 32, 77])
@pytest.mark.parametrize("exact,keep2", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, exact, keep2, q_n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    db = _unit(gen, N, cuda).to(dtype)
    q = _unit(gen, q_n, cuda)
    alive = (torch.rand(N, generator=gen, device=cuda) > 0.05).float()
    kw = dict(count=N - 1234, alive=alive, exact=exact, keep2=keep2)
    before = ft.LAUNCHES
    kv, ki = ft.fused_score_topk(db, q, 128, **kw)
    assert ft.LAUNCHES == before + 1
    pv, pi = ft.fused_score_topk_reference(db, q, 128, **kw)
    torch.cuda.synchronize()
    assert (kv - pv).abs().max().item() <= SCORE_TOL
    diff = ki != pi
    if diff.any():  # only near-ties may swap; the kernel's rows score what it says
        qi, pos = torch.nonzero(diff, as_tuple=True)
        rows = db[ki[qi, pos].long()].float()
        qq = q[qi] if exact and dtype == torch.float32 else q[qi].bfloat16().float()
        rr = rows if exact and dtype == torch.float32 else rows.bfloat16().float()
        assert ((qq * rr).sum(1) - kv[qi, pos]).abs().max().item() <= SCORE_TOL
    assert int(ki.max()) < N - 1234
    assert (alive[ki.long()] > 0).all()


def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((2, 512), device=cuda)
    with pytest.raises(ValueError):
        ft.fused_score_topk(torch.zeros((4096, 512), device=cuda), q, 4)
    with pytest.raises(ValueError):
        ft.fused_score_topk(torch.zeros((384, 4096), device=cuda).T, q[:, :384], 4)


def test_flat_index_on_the_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5000, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"v{i}" for i in range(5000)]
    gpu, cpu = FlatIndex(D, device=cuda), FlatIndex(D, device="cpu", use_fused=True)
    assert gpu.use_fused
    for idx in (gpu, cpu):
        idx.add(vecs, ids)
        idx.delete(ids[:40])
    q = vecs[100:108]
    before = ft.LAUNCHES
    hg, hc = gpu.search(q, 10), cpu.search(q, 10)
    assert ft.LAUNCHES > before
    for a, b in zip(hg, hc):
        assert [s for s, _ in a] == [s for s, _ in b]
        np.testing.assert_allclose([v for _, v in a], [v for _, v in b], atol=SCORE_TOL)
