"""The port's fused score+top-k scan (K1) against memex_tpu's on the CPU.

On CPU tensors `memex_tpu_torch.ops.fused_topk.fused_score_topk` runs its
plain PyTorch version; memex_tpu's Pallas kernel runs in interpret mode.
Both fold column c into slot c mod S in ascending column order, so the
candidate indices must agree exactly, ties included; values agree to
float32 summation-order noise (SCORE_ATOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu.ops.fused_topk import fused_score_topk as jax_fused
from memex_tpu_torch.ops import fused_topk as ft

torch.set_num_threads(2)

N, D, KK = 4096, 64, 32
# Both sides sum 64 products of unit-vector entries in float32, in
# different orders: a few ulps of a score <= 1.
SCORE_ATOL = 2e-6


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _run_both(db, q, k, count, alive, dtype, exact, keep2):
    jv, ji = jax_fused(jnp.asarray(db, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32),
                       jnp.asarray(q), k, count=count,
                       alive=None if alive is None else jnp.asarray(alive),
                       block_n=1024, banks=8, interpret=True, exact=exact, keep2=keep2)
    tdb = torch.from_numpy(db).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    tv, ti = ft.fused_score_topk(tdb, torch.from_numpy(q), k, count=count,
                                 alive=None if alive is None else torch.from_numpy(alive),
                                 banks=8, exact=exact, keep2=keep2)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("q_n", [3, 8])
@pytest.mark.parametrize("count", [N, N - 37])
@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("exact,keep2", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_matches_jax(dtype, exact, keep2, with_alive, count, q_n):
    rng = np.random.default_rng(7)
    db = _unit(rng, N, D)
    q = _unit(rng, q_n, D)
    alive = (rng.random(N) > 0.2).astype(np.float32) if with_alive else None
    jv, ji, tv, ti = _run_both(db, q, KK, count, alive, dtype, exact, keep2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=SCORE_ATOL)
    assert ti.max() < count
    if alive is not None:
        assert (alive[ti] > 0).all()


@pytest.mark.parametrize("keep2", [False, True])
def test_tie_rule_on_duplicated_rows(keep2):
    """Duplicated rows score exactly equal. Every row repeats 256 apart, so
    each slot (columns s, s + 1024, ...) holds four copies of one row: the
    fold keeps the earliest column (strict '>'), and keep2's second place
    is the next copy, as in the TPU's insertion order."""
    rng = np.random.default_rng(3)
    db = np.concatenate([_unit(rng, 256, D)] * (N // 256))
    q = _unit(rng, 4, D)
    jv, ji, tv, ti = _run_both(db, q, KK, N, None, "float32", True, keep2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)  # exact mode, identical rows: identical sums
    S = 1024
    if not keep2:
        assert (ti < S).all()
    else:
        for row in ti:
            pos = {int(c): i for i, c in enumerate(row)}
            for c, i in pos.items():
                assert c < 2 * S  # best and second copy only
                assert c < S or pos.get(c - S, KK) < i  # first copy ranks earlier


def test_wrapper_rejects_unsupported_dtype():
    db = torch.zeros((2048, D), dtype=torch.float16)
    with pytest.raises(TypeError):
        ft.fused_score_topk(db, torch.zeros((2, D)), 4)
    with pytest.raises(TypeError):
        ft.fused_score_topk(torch.zeros((2048, D)), torch.zeros((2, D), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ft.fused_score_bank_cuda(torch.zeros((2048, D)), torch.zeros((2, D)))


def test_cpu_tensors_never_count_as_kernel_launches():
    before = dict(ft.LAUNCHES)
    ft.fused_score_topk(torch.from_numpy(_unit(np.random.default_rng(0), 2048, D)),
                        torch.from_numpy(_unit(np.random.default_rng(1), 2, D)), 4)
    assert ft.LAUNCHES == before
