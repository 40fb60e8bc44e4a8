"""The port's EmbeddingEngine against memex_tpu's on the CPU: the fetch
dtype (argument and MEMEX_ENCODE_FETCH_DTYPE), data-parallel encode over a
device list against memex_tpu's 8-device mesh, and the bulk ingest path;
plus ops.host.fetch.

Both engines hold one tiny float32 MiniLM (hidden 64, 2 layers, 4 heads):
memex_tpu's init_params, carried into the port with params_from_numpy
through an HF checkpoint, which the port's engine loads in its own
__init__ (so the environment reaches it as in `serve`). The checkpoint
names no compute dtype, so the port's helper swaps in the float32 model
that memex_tpu's hand-built engine runs (tests/test_encoder.py:16-53).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from memex_tpu.embed.engine import EmbeddingEngine as JaxEngine
from memex_tpu.models.minilm import MiniLMConfig as JaxConfig
from memex_tpu.models.minilm import MiniLMEncoder, init_params
from memex_tpu.text import WordPieceTokenizer as JaxTokenizer
from memex_tpu_torch.embed.engine import EmbeddingEngine
from memex_tpu_torch.models.minilm import (MiniLM, MiniLMConfig, load_params,
                                           params_from_numpy, save_params)
from memex_tpu_torch.ops.host import fetch
from memex_tpu_torch.text import WordPieceTokenizer, encode_windows

torch.set_num_threads(2)

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            compute_dtype="float32")
L, STRIDE, DIM = 64, 16, 64
# float32 compute in both packages: the same math in other summation
# orders; tests/test_encoder.py holds memex_tpu's own paths to these bars.
DP_ATOL = 1e-4
BULK_ATOL = 1e-5
# A float16 / bfloat16 fetch in both packages rounds vectors that differ
# by float32 noise: they may land one rounding step apart (f16: 2^-11 of a
# component < 1, ~5e-4; bf16's step is 2^-8, but components of these
# 64-d unit vectors stay below 0.5, so a step is at most 2^-10).
FETCH_ATOL = 1e-3


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(vocab_size=JaxTokenizer().vocab_size, **TINY)
    return init_params(cfg, seed=0)


@pytest.fixture(scope="module")
def model_dir(jax_params, tmp_path_factory):
    """memex_tpu's weights as an HF checkpoint the port's engine loads."""
    tree = jax.tree.map(np.asarray, jax_params)
    cfg = MiniLMConfig(vocab_size=WordPieceTokenizer().vocab_size, **TINY)
    model = MiniLM(cfg)
    model.load_state_dict(params_from_numpy(tree))
    path = str(tmp_path_factory.mktemp("tiny_minilm"))
    save_params(path, cfg, model)
    return path


def jax_engine(params, max_batch, fetch_dtype="float32", mesh=None):
    """memex_tpu's engine built by hand, as tests/test_encoder.py builds it."""
    eng = JaxEngine.__new__(JaxEngine)
    eng.max_seq_length, eng.window_stride, eng.max_batch = L, STRIDE, max_batch
    eng.fetch_dtype, eng.mesh, eng.data_axis = fetch_dtype, mesh, "data"
    eng._lock = threading.Lock()
    eng.tokenizer = JaxTokenizer()
    eng.cfg = JaxConfig(vocab_size=eng.tokenizer.vocab_size, **TINY)
    eng.encoder = MiniLMEncoder(eng.cfg)
    eng.dim = DIM
    if mesh is None:
        eng.params = jax.device_put(params)
        eng._in_sharding = eng._out_sharding = None
        eng._n_dev = 1
    else:
        eng.params = jax.device_put(params, NamedSharding(mesh, P()))
        eng._in_sharding = eng._out_sharding = NamedSharding(mesh, P("data", None))
        eng._n_dev = len(mesh.devices.reshape(-1))
    return eng


def port_engine(model_dir, max_batch, **kw):
    """The port's engine through its own __init__, on float32 compute."""
    eng = EmbeddingEngine(model_dir, max_seq_length=L, window_stride=STRIDE,
                          max_batch=max_batch, device="cpu", **kw)
    eng.cfg = dataclasses.replace(eng.cfg, compute_dtype="float32")
    eng.model = load_params(model_dir, eng.cfg)[1].eval()
    eng._set_devices(eng.devices)
    return eng


def texts(n, what="passage"):
    return [f"{what} {i} about topic {i % 7} with some extra words" for i in range(n)]


_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("how,dtype", [("environment", "float16"),
                                       ("argument", "bfloat16"),
                                       ("environment", "bfloat16")])
def test_fetch_dtype_matches_memex_tpu_and_rounds_on_the_device(
        how, dtype, model_dir, jax_params, monkeypatch):
    """memex_tpu's `serve` builds its engine with no fetch_dtype, so the
    environment picks it; the port must read the same variable. Its
    vectors are then the float32 ones rounded to that dtype, bit for bit
    (the cast is the last step on the device), and memex_tpu's within a
    rounding step. 37 texts in chunks of at most 8: five copies back."""
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    f32 = port_engine(model_dir, 8).encode_batch(texts(37))
    if how == "environment":
        monkeypatch.setenv("MEMEX_ENCODE_FETCH_DTYPE", dtype)
        eng = port_engine(model_dir, 8)
    else:
        eng = port_engine(model_dir, 8, fetch_dtype=dtype)
    assert eng.fetch_dtype == dtype
    got = eng.encode_batch(texts(37))
    assert got.dtype == np.float32 and got.shape == (37, DIM)
    np.testing.assert_array_equal(got, torch.from_numpy(f32).to(_TORCH[dtype]).float().numpy())
    ref = jax_engine(jax_params, 8, dtype).encode_batch(texts(37))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FETCH_ATOL)


def test_fetch_dtype_defaults_to_float32_and_refuses_others(model_dir, monkeypatch):
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    assert port_engine(model_dir, 8).fetch_dtype == "float32"
    monkeypatch.setenv("MEMEX_ENCODE_FETCH_DTYPE", "int8")
    with pytest.raises(ValueError, match="fetch_dtype"):
        port_engine(model_dir, 8)
    with pytest.raises(ValueError, match="fetch_dtype"):
        port_engine(model_dir, 8, fetch_dtype="float64")


@pytest.mark.parametrize("n_dev", [2, 3, 8])
@pytest.mark.parametrize("n_texts,max_batch", [(21, 32), (37, 16)])
def test_data_parallel_matches_memex_tpus_mesh(n_dev, n_texts, max_batch, model_dir,
                                               jax_params, monkeypatch):
    """devices=["cpu"] * n against memex_tpu's engine over the 8-device CPU
    mesh (tests/conftest.py) and against one device: the bucket rounds up
    to a multiple of n, each block runs on its entry, and the entries
    share one replica."""
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    eng = port_engine(model_dir, max_batch, devices=["cpu"] * n_dev)
    assert len({id(r) for r in eng._replicas}) == 1
    rows = []
    hook = eng.model.register_forward_hook(lambda m, a, o: rows.append(a[0].shape[0]))
    got = eng.encode_batch(texts(n_texts))
    hook.remove()
    assert len(rows) % n_dev == 0 and len(set(rows)) <= 2
    assert all(r * n_dev >= 8 for r in rows)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    assert mesh.devices.size == 8, "tests/conftest.py gives JAX 8 CPU devices"
    ref = jax_engine(jax_params, max_batch, mesh=mesh).encode_batch(texts(n_texts))
    np.testing.assert_allclose(got, ref, rtol=0, atol=DP_ATOL)
    one = port_engine(model_dir, max_batch).encode_batch(texts(n_texts))
    np.testing.assert_allclose(got, one, rtol=0, atol=DP_ATOL)


@pytest.mark.parametrize("n", [70, 65])
def test_bulk_matches_memex_tpu_and_the_chunked_path(n, model_dir, jax_params, monkeypatch):
    """From 8 x max_batch windows _encode_padded takes _encode_bulk; its
    batches are [max_batch, L] views of fixed super-chunks (the tail
    padded), it fills memex_tpu's phase keys, and it agrees with memex_tpu's
    bulk path and with the port's chunked path."""
    monkeypatch.delenv("MEMEX_ENCODE_FETCH_DTYPE", raising=False)
    eng = port_engine(model_dir, 8)
    ids, mask = encode_windows(texts(n, "bulk window"), eng.tokenizer, L)
    shapes = []
    hook = eng.model.register_forward_hook(lambda m, a, o: shapes.append(tuple(a[0].shape)))
    phases = {}
    got = eng._encode_bulk(ids, mask, np.empty((n, DIM), np.float32), phases=phases)
    hook.remove()
    assert set(shapes) == {(8, L)} and len(shapes) == -(-n // 8)
    jphases = {}
    ref = jax_engine(jax_params, 8)._encode_bulk(ids, mask, np.empty((n, DIM), np.float32),
                                                 phases=jphases)
    assert set(phases) == set(jphases) == {"dispatch_s", "device_sync_s", "fetch_s"}
    np.testing.assert_allclose(got, ref, rtol=0, atol=BULK_ATOL)
    chunked = port_engine(model_dir, 128)._encode_padded(ids, mask)  # n < 8 * 128
    np.testing.assert_allclose(got, chunked, rtol=0, atol=BULK_ATOL)
    taken = []
    bulk = eng._encode_bulk
    eng._encode_bulk = lambda *a, **kw: taken.append(len(a[0])) or bulk(*a, **kw)
    np.testing.assert_array_equal(eng._encode_padded(ids, mask), got)
    assert taken == [n]


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.int32, torch.float16, torch.int8, torch.int64),
    (torch.bfloat16, torch.float32),
])
def test_fetch_keeps_order_shapes_and_dtypes(dtypes):
    """CPU tensors pass through in order with their shapes and dtypes;
    numpy has no bfloat16, so bfloat16 arrives widened to float32."""
    gen = torch.Generator().manual_seed(0)
    ts = [(torch.randn((i + 2, 3), generator=gen) * 50).to(dt) for i, dt in enumerate(dtypes)]
    out = fetch(*ts)
    assert len(out) == len(ts)
    for t, a in zip(ts, out):
        assert isinstance(a, np.ndarray) and a.shape == tuple(t.shape)
        want = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        assert a.dtype == torch.empty(0, dtype=want).numpy().dtype
        np.testing.assert_array_equal(a, t.to(want).numpy())
    assert fetch() == ()
