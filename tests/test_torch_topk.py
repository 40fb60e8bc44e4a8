"""The port's exact top-k ops against memex_tpu's (jax.lax.top_k based).

Both break ties by the lower column; inputs are shared float32 scores,
so values must match exactly and indices position by position."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.ops import topk as jtopk
from memex_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)


def _scores(seed: int, q: int, n: int, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ties:  # few distinct values: every top-k boundary is a tie
        return rng.integers(0, 7, size=(q, n)).astype(np.float32)
    return rng.standard_normal((q, n)).astype(np.float32)


def _check(jv, ji, tv, ti):
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("count", [None, 777])
def test_exact_topk_matches_jax(count, ties):
    s = _scores(1, 4, 3000, ties)
    jv, ji = jtopk.exact_topk(jnp.asarray(s), 12, count=count)
    tv, ti = ttopk.exact_topk(torch.from_numpy(s), 12, count=count)
    _check(jv, ji, tv, ti)


@pytest.mark.parametrize("n", [1000, 10000])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("count", [None, 5000])
def test_blockwise_topk_matches_jax(count, ties, n):
    s = _scores(2, 3, n, ties)
    jv, ji = jtopk.blockwise_topk(jnp.asarray(s), 9, count=count, block=1024)
    tv, ti = ttopk.blockwise_topk(torch.from_numpy(s), 9, count=count, block=1024)
    _check(jv, ji, tv, ti)


def test_blockwise_equals_exact_with_masking():
    s = _scores(3, 2, 9000, True)
    bv, bi = ttopk.blockwise_topk(torch.from_numpy(s), 20, count=4321, block=512)
    ev, ei = ttopk.exact_topk(torch.from_numpy(s), 20, count=4321)
    assert torch.equal(bv, ev) and torch.equal(bi, ei)
    assert int(bi.max()) < 4321
