"""The local LLM's forward on the card against the CPU, both families, at
the tiny configs (the CPU side is held to memex_tpu by test_torch_llm.py
and test_torch_gptj.py). Marked `gpu`: without a CUDA card every test here
skips. Imports torch and the port only, so it runs on a card's machine
without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_llm_gpu.py
"""

import numpy as np
import pytest
import torch

from memex_tpu_torch.llm.local import gptj as tg
from memex_tpu_torch.llm.local import model as tm
from memex_tpu_torch.llm.local.runtime import ByteTokenizer, LocalLLM, _tree_to

pytestmark = pytest.mark.gpu

# float32 compute on both sides: cuBLAS and the CPU's BLAS sum the same
# products in other orders, a few float32 ulps of logits below 1 (the
# tolerance test_torch_llm.py holds the CPU to memex_tpu with).
LOGIT_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _config(family):
    if family == "gptj":
        return tg.GptJConfig.tiny(), tg.init_params
    return tm.LlamaConfig.tiny(), tm.init_params


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_tiny_forward_on_the_card_matches_the_cpu(cuda, family, dtype):
    """Prefill of 12 tokens and one cached decode step."""
    cfg, init = _config(family)
    params = tm.convert_params(init(cfg, seed=0, device=CPU), dtype)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 512, size=(1, 13)))

    def run(p, dev):
        cache = tm.init_cache(cfg, device=dev)
        x = ids.to(dev)
        lg, cache = tm.model_forward(cfg, p, x[:, :12], torch.arange(12, device=dev)[None],
                                     cache, 0)
        st, _ = tm.model_forward(cfg, p, x[:, 12:], torch.full((1, 1), 12, device=dev), cache,
                                 torch.full((), 12, device=dev))
        return torch.cat([lg[0], st[0]]).cpu().numpy()

    np.testing.assert_allclose(run(_tree_to(params, cuda), cuda), run(params, CPU),
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("family", ["llama", "gptj"])
def test_greedy_chat_on_the_card_matches_the_cpu(cuda, family):
    """Greedy batch and streaming text on the card: the CPU's."""
    cfg, init = _config(family)
    cfg = type(cfg)(**{**cfg.__dict__, "vocab_size": ByteTokenizer.vocab_size,
                       "max_context": 640})
    params = init(cfg, seed=1, device=CPU)
    greedy = tm.SamplerConfig(temperature=0.0)
    from memex_tpu_torch.llm.base import ChatMessage, ChatRole

    msgs = [ChatMessage(ChatRole.User, "hello card")]
    on_cpu = LocalLLM(cfg, params, ByteTokenizer(), greedy, device=CPU)
    on_card = LocalLLM(cfg, params, ByteTokenizer(), greedy, device=cuda)
    want = on_cpu.chat_completion("m", msgs, max_new=24)
    assert on_card.chat_completion("m", msgs, max_new=24) == want
    pieces = []
    assert on_card.chat_completion("m", msgs, on_token=pieces.append, max_new=24) == want
    assert "".join(pieces) == want
