"""Encoder fine-tuning on the card against the CPU at a tiny config (the
CPU side is held to memex_tpu by test_torch_train.py). Marked `gpu`:
without a CUDA card every test here skips. Imports torch and the port
only, so it runs on a card's machine without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import numpy as np
import pytest
import torch

from memex_tpu_torch.models.minilm import MiniLM, MiniLMConfig
from memex_tpu_torch.train import TrainConfig, init_train_state, make_train_step

pytestmark = pytest.mark.gpu

# float32 on both sides (TF32 off): cuBLAS and the CPU's BLAS sum the same
# products in other orders, a few ulps of activations and gradients. Adam
# makes each coordinate's update ~lr whatever the gradient's size, so a
# step moves params by <= lr (1e-3 here) and the two sides' params agree
# to a small fraction of that.
LOSS_TOL = 1e-5
PARAM_TOL = 2e-5
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg():
    return MiniLMConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64, compute_dtype="float32")


def _batch(seed: int, b: int = 16, length: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("q", "d"):
        out[f"{side}_ids"] = rng.integers(5, 128, (b, length)).astype(np.int32)
        lens = rng.integers(4, length + 1, b)
        out[f"{side}_mask"] = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    return out


def _run(device, devices=None, steps=2):
    cfg, tc = _cfg(), TrainConfig(learning_rate=1e-3)
    state = init_train_state(cfg, MiniLM(cfg).init_random(0), tc, device=device)
    step = make_train_step(cfg, tc, devices)
    losses = []
    for i in range(steps):
        state, m = step(state, _batch(i))
        losses.append(float(m["loss"]))
    return state, losses


def _params(state) -> dict:
    return {k: v.detach().cpu() for k, v in state["params"].state_dict().items()}


def test_card_step_matches_cpu(cuda):
    got, got_l = _run(cuda)
    want, want_l = _run(CPU)
    np.testing.assert_allclose(got_l, want_l, rtol=0, atol=LOSS_TOL)
    g, w = _params(got), _params(want)
    for k in w:
        torch.testing.assert_close(g[k], w[k], rtol=0, atol=PARAM_TOL, msg=k)


def test_card_steps_are_bit_equal_across_runs(cuda):
    a, la = _run(cuda, steps=3)
    b, lb = _run(cuda, steps=3)
    assert la == lb
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for ma, mb in zip(a["opt"].moments("nu"), b["opt"].moments("nu")):
        assert torch.equal(ma, mb)


def test_two_entries_of_one_card_match_one_entry(cuda):
    one, l1 = _run(cuda)
    two, l2 = _run(cuda, devices=[cuda, cuda])
    np.testing.assert_allclose(l2, l1, rtol=0, atol=LOSS_TOL)
    p1, p2 = _params(one), _params(two)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=PARAM_TOL, msg=k)


def test_two_cards_match_one(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    one, l1 = _run(cuda)
    two, l2 = _run(cuda, devices=[cuda, torch.device("cuda", 1)])
    np.testing.assert_allclose(l2, l1, rtol=0, atol=LOSS_TOL)
    p1, p2 = _params(one), _params(two)
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=PARAM_TOL, msg=k)
