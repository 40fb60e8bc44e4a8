"""The port's MiniLM against memex_tpu's MiniLMEncoder on shared weights,
and the HF checkpoint round trip between the two packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from memex_tpu.models import minilm as jm
from memex_tpu_torch.models import minilm as tm

torch.set_num_threads(2)

# float32 compute: same math, different summation orders (matmul blocking,
# attention kernels) -> float32 noise on unit vectors.
F32_ATOL = 2e-5
# bf16 compute: both round dense outputs and the residual stream to bf16,
# at slightly different points (nn.Linear rounds once after its fused bias
# add, JAX rounds the product and then the sum; attention internals differ),
# so components of the 64-d unit vectors (~0.12 each) differ by a few bf16
# ulps at most.
BF16_ATOL = 3e-2
BF16_MIN_COS = 0.999


def _cfg(compute_dtype):
    return dict(vocab_size=381, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=128, compute_dtype=compute_dtype)


def _params(seed=0):
    return jm.init_params(jm.MiniLMConfig(**_cfg("float32")), seed=seed)


def _inputs(seed, batch=5, length=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 381, size=(batch, length)).astype(np.int32)
    lens = rng.integers(1, length + 1, size=batch)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


def _torch_model(params, compute_dtype):
    model = tm.MiniLM(tm.MiniLMConfig(**_cfg(compute_dtype)))
    np_tree = {"embeddings": {k: np.asarray(v) for k, v in params["embeddings"].items()},
               "layers": [{k: np.asarray(v) for k, v in lp.items()} for lp in params["layers"]]}
    model.load_state_dict(tm.params_from_numpy(np_tree))
    return model.cast_to_compute().eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_forward_matches_jax(seed):
    params = _params(seed)
    ids, mask = _inputs(seed)
    ref = np.asarray(jm.MiniLMEncoder(jm.MiniLMConfig(**_cfg("float32"))).apply(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        out = _torch_model(params, "float32")(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_matches_jax(seed):
    params = _params(seed)
    ids, mask = _inputs(seed + 10)
    ref = np.asarray(jm.MiniLMEncoder(jm.MiniLMConfig(**_cfg("bfloat16"))).apply(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        out = _torch_model(params, "bfloat16")(torch.from_numpy(ids),
                                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=BF16_ATOL)
    assert (np.sum(out * ref, axis=1) >= BF16_MIN_COS).all()


def test_outputs_are_unit_vectors_and_pad_invariant():
    params = _params(2)
    model = _torch_model(params, "float32")
    ids, mask = _inputs(3, batch=2, length=16)
    wide_ids = np.zeros((2, 64), np.int32)
    wide_mask = np.zeros((2, 64), np.int32)
    wide_ids[:, :16], wide_mask[:, :16] = ids, mask
    with torch.no_grad():
        a = model(torch.from_numpy(ids), torch.from_numpy(mask))
        b = model(torch.from_numpy(wide_ids), torch.from_numpy(wide_mask))
    np.testing.assert_allclose(a.norm(dim=1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_ATOL)


def test_checkpoint_round_trip_between_packages(tmp_path):
    """memex_tpu save -> port load -> port save writes the same tensors bit
    for bit, and memex_tpu loads the port's file back to its own params."""
    params = _params(4)
    cfg = jm.MiniLMConfig(**_cfg("float32"))
    jm.save_params(str(tmp_path / "jax"), cfg, params, vocab=["[PAD]", "a"])
    tcfg, model = tm.load_params(str(tmp_path / "jax"))
    assert tcfg.num_layers == 2 and tcfg.hidden_size == 64
    tm.save_params(str(tmp_path / "torch"), tcfg, model, vocab=["[PAD]", "a"])
    a = load_file(str(tmp_path / "jax" / "model.safetensors"))
    b = load_file(str(tmp_path / "torch" / "model.safetensors"))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
    _, back = jm.load_params(str(tmp_path / "torch"))
    for lp, lb in zip(params["layers"], back["layers"]):
        for leaf in lp:
            assert np.array_equal(np.asarray(lp[leaf]), np.asarray(lb[leaf])), leaf
    assert (tmp_path / "torch" / "vocab.txt").read_text() == "[PAD]\na\n"


def test_params_from_numpy_matches_checkpoint_load(tmp_path):
    params = _params(5)
    jm.save_params(str(tmp_path), jm.MiniLMConfig(**_cfg("float32")), params)
    _, loaded = tm.load_params(str(tmp_path))
    converted = _torch_model(params, "float32")
    for (n1, p1), (n2, p2) in zip(loaded.state_dict().items(),
                                  converted.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2), n1
