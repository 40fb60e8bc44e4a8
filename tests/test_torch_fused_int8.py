"""The port's int8 scans (K2, K3) and quantizers against memex_tpu's on the
CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions;
memex_tpu's Pallas kernels run in interpret mode. K2's dot is exact
integer arithmetic and its score one float32 rounding of raw * scale on
both sides, so its values and indices must be equal, bit for bit. K3
sums bf16 x int8 products in float32 in different orders: indices equal,
values within SCORE_ATOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memex_tpu import native_lib
from memex_tpu.ops import fused_topk as jft
from memex_tpu_torch.ops import fused_topk as ft

torch.set_num_threads(2)

N, D, KK = 4096, 64, 32
# K3: 64 products of a bf16 query entry (<= 1) and an int8 code (<= 127)
# summed in float32 in two orders, then scaled by ~|row|/127: a few ulps
# of a score <= 1.
SCORE_ATOL = 2e-6


def _unit(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _corpus(seed, n=N):
    rng = np.random.default_rng(seed)
    codes, scales = native_lib.np_quantize_rows_int8(_unit(rng, n))
    return rng, codes, scales


def test_quantizers_match_jax_and_native_lib():
    """Bit-equal to memex_tpu's quantizers as they run, jitted. native_lib
    (the ingest quantizer of both packages) divides by 127 where XLA
    multiplies by float32(1/127): its scales may differ by one ulp, and a
    code by one level where a value sits at a rounding midpoint."""
    rng = np.random.default_rng(0)
    x = np.concatenate([_unit(rng, 500), rng.standard_normal((12, D)).astype(np.float32) * 3,
                        np.zeros((2, D), np.float32)])
    tq, ts = ft.quantize_rows_int8(torch.from_numpy(x))
    jq, js = jax.jit(jft.quantize_rows_int8)(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    refined = ft.quantize_rows_int8_refine(torch.from_numpy(x))
    for t, j in zip(refined, jft.quantize_rows_int8_refine(jnp.asarray(x))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    nq, ns = native_lib.np_quantize_rows_int8(x)
    np.testing.assert_allclose(ns, ts.numpy(), rtol=2 ** -23, atol=0)
    assert np.abs(nq.astype(np.int32) - tq.numpy()).max() <= 1
    assert (nq == tq.numpy()).mean() > 0.999
    nrq = native_lib.np_quantize_rows_int8_refine(x)
    np.testing.assert_array_equal(nrq[0], nq)
    np.testing.assert_array_equal(nrq[1], ns)


def _run_int8q(codes, scales, q, k, count, alive, keep2):
    jv, ji = jft.fused_score_topk_int8q(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q), k, count=count,
        alive=None if alive is None else jnp.asarray(alive),
        block_n=1024, banks=4, keep2=keep2, interpret=True)
    tv, ti = ft.fused_score_topk_int8q(
        torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(q), k,
        count=count, alive=None if alive is None else torch.from_numpy(alive),
        banks=4, keep2=keep2)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("q_n", [3, 40])
@pytest.mark.parametrize("count", [N, N - 37])
@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("keep2", [False, True])
def test_plain_k2_matches_jax_bit_for_bit(keep2, with_alive, count, q_n):
    rng, codes, scales = _corpus(7)
    q = _unit(rng, q_n)
    alive = (rng.random(N) > 0.2).astype(np.float32) if with_alive else None
    jv, ji, tv, ti = _run_int8q(codes, scales, q, KK, count, alive, keep2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert ti.max() < count
    if alive is not None:
        assert (alive[ti] > 0).all()


def test_k2_masked_slots_keep_the_sentinel():
    """Fewer live columns than k: the empty slots stay at -1e30 after the
    query scale is folded in, on both sides."""
    rng, codes, scales = _corpus(8)
    q = _unit(rng, 3) * 1e-3  # a tiny query scale
    jv, ji, tv, ti = _run_int8q(codes, scales, q, KK, 20, None, False)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti[:, :20], ji[:, :20])
    assert (tv[:, 20:] == ft.NEG_INF).all()


@pytest.mark.parametrize("keep2", [False, True])
def test_k2_tie_rule_on_duplicated_rows(keep2):
    """Duplicated rows score exactly equal. Every row repeats 128 apart, so
    each slot (columns s, s + 512, ...) holds eight copies of one row: the
    fold keeps the earliest column (strict '>'), and keep2's second place
    is the next copy, as in the TPU's insertion order."""
    rng = np.random.default_rng(3)
    codes, scales = native_lib.np_quantize_rows_int8(_unit(rng, 128))
    codes, scales = np.concatenate([codes] * (N // 128)), np.concatenate([scales] * (N // 128))
    q = _unit(rng, 4)
    jv, ji, tv, ti = _run_int8q(codes, scales, q, KK, N, None, keep2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    S = 512
    if not keep2:
        assert (ti < S).all()
    else:
        for row in ti:
            pos = {int(c): i for i, c in enumerate(row)}
            for c, i in pos.items():
                assert c < 2 * S  # best and second copy only
                assert c < S or pos.get(c - S, KK) < i  # first copy ranks earlier


@pytest.mark.parametrize("q_n", [3, 40])
@pytest.mark.parametrize("count", [N, N - 37])
@pytest.mark.parametrize("with_alive", [False, True])
def test_plain_k3_matches_jax(with_alive, count, q_n):
    rng, codes, scales = _corpus(9)
    q = _unit(rng, q_n)
    alive = (rng.random(N) > 0.2).astype(np.float32) if with_alive else None
    jv, ji = jft.fused_score_topk_int8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q), KK, count=count,
        alive=None if alive is None else jnp.asarray(alive),
        block_n=1024, banks=8, interpret=True)
    tv, ti = ft.fused_score_topk_int8(
        torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(q), KK,
        count=count, alive=None if alive is None else torch.from_numpy(alive), banks=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=SCORE_ATOL)


def test_int8_wrappers_reject_what_they_cannot_take():
    codes = torch.zeros((2048, D), dtype=torch.int8)
    scales = torch.ones(2048)
    q = torch.zeros((2, D))
    with pytest.raises(TypeError):
        ft.fused_score_topk_int8q(codes.float(), scales, q, 4)
    with pytest.raises(ValueError):
        ft.fused_score_topk_int8(codes, scales[:10], q, 4)
    with pytest.raises(ValueError):
        ft.fused_score_topk_int8q(codes, scales, q[:, :32], 4)
    with pytest.raises(ValueError):  # CPU tensors never reach a kernel
        ft.fused_score_bank_int8q_cuda(codes, scales, codes[:2])
    with pytest.raises(ValueError):
        ft.fused_score_bank_int8_cuda(codes, scales, q)


def test_cpu_tensors_never_count_as_int8_launches():
    rng, codes, scales = _corpus(1, 2048)
    before = dict(ft.LAUNCHES)
    args = (torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(_unit(rng, 2)), 4)
    ft.fused_score_topk_int8q(*args)
    ft.fused_score_topk_int8(*args)
    assert ft.LAUNCHES == before
