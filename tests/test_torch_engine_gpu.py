"""The encoder's ingest paths on the card: the bulk path against the
chunked one, data-parallel encode over [cuda:0, cuda:0] and over every
visible card against one, the fetch dtype's cast on the device, and
ops.host.fetch from the card. Marked `gpu`: without a CUDA card every test
here skips. Run on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_engine_gpu.py

The engines compute in float32 (TF32 off) on seeded random weights at
all-MiniLM-L12-v2 width, so the paths agree within float32 noise: they
run the same math on other batch shapes, whose GEMMs may sum in other
orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

from memex_tpu_torch.embed.engine import EmbeddingEngine
from memex_tpu_torch.models.minilm import MiniLM
from memex_tpu_torch.ops.host import fetch
from memex_tpu_torch.text import WordPieceTokenizer

pytestmark = pytest.mark.gpu

L = 128
F32_ATOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    return torch.device("cuda", 0)


def engine(max_batch, **kw):
    eng = EmbeddingEngine(None, max_seq_length=L, max_batch=max_batch, device="cuda:0", **kw)
    eng.cfg = dataclasses.replace(eng.cfg, compute_dtype="float32")
    eng.model = MiniLM(eng.cfg).init_random(0).to(eng.device).eval()
    eng._set_devices(eng.devices)
    return eng


def windows(n, seed=0):
    """[n, L] ids below the engine's vocabulary (its fallback tokenizer's)
    and their mask: 8 to L tokens a window, the rest padding (id 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, WordPieceTokenizer().vocab_size, size=(n, L)).astype(np.int32)
    lens = rng.integers(8, L + 1, size=n)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def test_bulk_path_matches_the_chunked_path(cuda):
    """600 windows at max_batch 64 take the bulk path (>= 512): ten
    [64, L] batches over two super-chunks, the last batch padded."""
    ids, mask = windows(600)
    eng = engine(64)
    shapes = []
    hook = eng.model.register_forward_hook(lambda m, a, o: shapes.append(tuple(a[0].shape)))
    phases = {}
    got = eng._encode_bulk(ids, mask, np.empty((600, 384), np.float32), phases=phases)
    hook.remove()
    assert set(shapes) == {(64, L)} and len(shapes) == 10
    assert set(phases) == {"dispatch_s", "device_sync_s", "fetch_s"}
    assert np.array_equal(eng._encode_padded(ids, mask), got)
    chunked = engine(1024)._encode_padded(ids, mask)
    np.testing.assert_allclose(got, chunked, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_fetch_dtype_rounds_on_the_card(cuda, dtype):
    ids, mask = windows(600, seed=1)
    f32 = engine(64)._encode_padded(ids, mask)
    got = engine(64, fetch_dtype=dtype)._encode_padded(ids, mask)
    want = torch.from_numpy(f32).to(getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entries", ["cuda:0 twice", "every card"])
def test_data_parallel_matches_one_device(cuda, entries):
    if entries == "every card":
        n = torch.cuda.device_count()
        if n < 2:
            pytest.skip("needs two cards")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = ["cuda:0", "cuda:0"]
    ids, mask = windows(300, seed=2)
    eng = engine(128, devices=devices)
    assert len({id(r) for r in eng._replicas}) == len(set(devices))
    got = eng._encode_padded(ids, mask)
    one = engine(128)._encode_padded(ids, mask)
    np.testing.assert_allclose(got, one, rtol=0, atol=F32_ATOL)


def test_fetch_from_the_card_equals_cpu_copies(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    ts = [torch.randn((1000, 40), generator=gen, device=cuda),
          torch.randint(0, 1 << 30, (1000, 40), generator=gen, device=cuda, dtype=torch.int32),
          torch.randn((7,), generator=gen, device=cuda).bfloat16()]
    out = fetch(*ts)
    for t, a in zip(ts, out, strict=True):
        np.testing.assert_array_equal(a, t.float().cpu().numpy() if t.dtype == torch.bfloat16
                                      else t.cpu().numpy())
