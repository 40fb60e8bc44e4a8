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


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("count", [None, 777])
def test_approx_topk_matches_jax(count, ties):
    """memex_tpu's lax.approx_max_k computes the exact top-k off the TPU;
    the port's approx_topk is that exact top-k, int32 indices included."""
    s = _scores(4, 3, 3000, ties)
    jv, ji = jtopk.approx_topk(jnp.asarray(s), 12, count=count)
    tv, ti = ttopk.approx_topk(torch.from_numpy(s), 12, count=count)
    assert ti.dtype == torch.int32
    _check(jv, ji, tv, ti)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("method", ["exact_f32", "exact", "blockwise", "approx"])
@pytest.mark.parametrize("count", [None, 3333])
def test_score_topk_matches_jax(method, count):
    """Each method against memex_tpu's jitted score_topk on the same rows:
    ids equal, values within 1e-5 (float32 sums of the same products in
    other orders; bf16-rounded operands for all but exact_f32). 5000 rows
    with block 1024 take blockwise's two stages."""
    rng = np.random.default_rng(5)
    db, q = _unit_rows(rng, 5000, 48), _unit_rows(rng, 7, 48)
    jv, ji = jtopk.score_topk(jnp.asarray(db), jnp.asarray(q), 10, count=count, method=method,
                              block=1024)
    tv, ti = ttopk.score_topk(torch.from_numpy(db), torch.from_numpy(q), 10, count=count,
                              method=method, block=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if count is not None:
        assert int(ti.max()) < count


@pytest.mark.parametrize("method", ["exact_f32", "exact", "blockwise", "approx"])
def test_score_topk_ties_go_to_the_lower_row(method):
    """Duplicated rows score alike under every method: the lower row wins,
    as lax.top_k's, in the port and in memex_tpu."""
    rng = np.random.default_rng(6)
    base = _unit_rows(rng, 600, 32)
    db = np.concatenate([base, base, base])  # row r, r + 600, r + 1200 tie
    q = base[[3, 250, 599]] + 0.01 * rng.standard_normal((3, 32)).astype(np.float32)
    jv, ji = jtopk.score_topk(jnp.asarray(db), jnp.asarray(q), 9, method=method, block=512)
    tv, ti = ttopk.score_topk(torch.from_numpy(db), torch.from_numpy(q), 9, method=method,
                              block=512)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    first = ti.numpy()[:, :3]
    assert (first == first[:, :1] + np.array([0, 600, 1200])).all()


def test_ops_exports_memex_tpus_names():
    import memex_tpu.ops as jops
    import memex_tpu_torch.ops as tops

    assert tops.__all__ == jops.__all__
    assert all(callable(getattr(tops, name)) for name in tops.__all__)
