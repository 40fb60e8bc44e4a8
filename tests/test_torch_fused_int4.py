"""The port's int4 scan (K4) and its int8 rerank against memex_tpu's on the
CPU.

memex_tpu keeps the packed codes transposed, [D/2, N] (its TPU tile
layout); the port keeps them row-major, [N, D/2]. The tests pack with
each package's own function and compare through a transpose.

K4's shift mode is exact integer arithmetic, and its score one float32
rounding of raw * (scale8 * 127/7) on both sides: the banks must be equal
bit for bit. Deferred mode takes bf16 query operands, but every product
and partial sum is an integer below 2^24 (at these sizes and at D = 384),
so its bank is held to bit equality too. The rerank re-scores bf16 x int8 dots in
float32 in different orders: indices equal, values within SCORE_ATOL."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from memex_tpu import native_lib
from memex_tpu.ops import fused_topk as jft
from memex_tpu_torch.ops import fused_topk as ft

torch.set_num_threads(2)

N, D, K = 4096, 64, 10
# The rerank's 64 bf16 x int8 products summed in float32 in two orders,
# times a scale ~|row|/127: a few ulps of a score <= 1.
SCORE_ATOL = 2e-6


def _unit(rng, n, d=D):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _corpus(seed, n=N):
    """Both packages' int4 packing of one corpus, plus its int8 rerank copy."""
    rng = np.random.default_rng(seed)
    x = _unit(rng, n)
    p_t, _ = jft.np_quantize_rows_int4(x)   # [D/2, N]
    p, _ = ft.np_quantize_rows_int4(x)      # [N, D/2]
    codes, scales = native_lib.np_quantize_rows_int8(x)
    return rng, p_t, p, codes, scales


def test_int4_packing_is_the_transpose_of_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([_unit(rng, 300), np.zeros((2, D), np.float32)])
    jp, js = jft.np_quantize_rows_int4(x)
    tp, ts = ft.np_quantize_rows_int4(x)
    assert tp.shape == (302, D // 2) and tp.flags.c_contiguous
    np.testing.assert_array_equal(tp, jp.T)
    np.testing.assert_array_equal(ts, js)
    # Checkpoint restore: the same re-derivation from int8 codes.
    codes, _ = native_lib.np_quantize_rows_int8(x)
    c4 = np.clip(np.round(codes.astype(np.float32) * (7.0 / 127.0)), -7, 7).astype(np.int32)
    np.testing.assert_array_equal(ft.pack_int4_from_int8(codes),
                                  (c4[:, : D // 2] + 16 * c4[:, D // 2 :]).astype(np.int8))


def _jax_bank(p_t, scales, q, count, alive, banks, deferred, keep2):
    @functools.partial(jax.jit, static_argnames=())
    def run(p_t, scales, q, count, alive):
        # As fused_score_topk_int4_rerank computes it, inside one jit.
        return jft._int4q_candidates(
            p_t, scales * (127.0 / 7.0), q, jnp.full((1,), count, jnp.int32), alive,
            block_n=1024, banks=banks, deferred=deferred, interpret=True, keep2=keep2)

    v, i = run(jnp.asarray(p_t), jnp.asarray(scales), jnp.asarray(q), count,
               None if alive is None else jnp.asarray(alive))
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("q_n", [3, 40])
@pytest.mark.parametrize("count", [N, N - 37])
@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("keep2", [False, True])
@pytest.mark.parametrize("deferred", [False, True])
def test_plain_k4_bank_matches_jax_bit_for_bit(deferred, keep2, with_alive, count, q_n):
    rng, p_t, p, _, scales = _corpus(5)
    q = _unit(rng, q_n)
    alive = (rng.random(N) > 0.2).astype(np.float32) if with_alive else None
    jv, ji = _jax_bank(p_t, scales, q, count, alive, 8, deferred, keep2)
    tv, ti = ft.int4q_candidates(
        torch.from_numpy(p), torch.from_numpy(scales), torch.from_numpy(q), count,
        None if alive is None else torch.from_numpy(alive), banks=8,
        deferred=deferred, keep2=keep2)
    assert tv.shape == (q_n, (2 if keep2 else 1) * 1024)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("q_n", [3, 40])
@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("deferred,keep2,banks", [(False, False, 8), (True, False, 8),
                                                  (False, True, 16), (True, True, 16)])
def test_int4_rerank_matches_jax(deferred, keep2, banks, with_alive, q_n):
    rng, p_t, p, codes, scales = _corpus(6)
    q = _unit(rng, q_n)
    alive = (rng.random(N) > 0.1).astype(np.float32) if with_alive else None
    count = N - 100
    jv, ji = jft.fused_score_topk_int4_rerank(
        jnp.asarray(p_t), jnp.asarray(scales), jnp.asarray(codes), jnp.asarray(q), K,
        count=count, alive=None if alive is None else jnp.asarray(alive), rerank=64,
        block_n=N, banks=banks, deferred=deferred, keep2=keep2, interpret=True)
    tv, ti = ft.fused_score_topk_int4_rerank(
        torch.from_numpy(p), torch.from_numpy(scales), torch.from_numpy(codes),
        torch.from_numpy(q), K, count=count,
        alive=None if alive is None else torch.from_numpy(alive), rerank=64, banks=banks,
        deferred=deferred, keep2=keep2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=SCORE_ATOL)
    assert ti.numpy().max() < count
    if alive is not None:
        assert (alive[ti.numpy()] > 0).all()
    # The reference entry point is the same computation.
    rv, ri = ft.fused_score_topk_int4_rerank_reference(
        torch.from_numpy(p), torch.from_numpy(scales), torch.from_numpy(codes),
        torch.from_numpy(q), K, count=count,
        alive=None if alive is None else torch.from_numpy(alive), rerank=64, banks=banks,
        deferred=deferred, keep2=keep2)
    assert torch.equal(rv, tv) and torch.equal(ri, ti)


@pytest.mark.parametrize("q_n", [2, 31, 33, 64, 128])
@pytest.mark.parametrize("deferred,keep2,banks", [(False, False, 8), (True, False, 8),
                                                  (False, True, 16), (True, True, 16)])
def test_int4_rerank_matches_jax_at_the_batches_its_tiles_split_on(deferred, keep2, banks, q_n):
    """The card's kernel scores 16 queries a pair of n-tiles, 32 a fold
    pass and a second group on further warps: the same batch sizes through
    the plain version and memex_tpu, through the transpose. Ids equal,
    values within SCORE_ATOL (the rerank's float32 sums)."""
    rng, p_t, p, codes, scales = _corpus(20 + q_n)
    q = _unit(rng, q_n)
    alive = (rng.random(N) > 0.1).astype(np.float32)
    count = N - 100
    jv, ji = jft.fused_score_topk_int4_rerank(
        jnp.asarray(p_t), jnp.asarray(scales), jnp.asarray(codes), jnp.asarray(q), K,
        count=count, alive=jnp.asarray(alive), rerank=64, block_n=N, banks=banks,
        deferred=deferred, keep2=keep2, interpret=True)
    tv, ti = ft.fused_score_topk_int4_rerank(
        torch.from_numpy(p), torch.from_numpy(scales), torch.from_numpy(codes),
        torch.from_numpy(q), K, count=count, alive=torch.from_numpy(alive), rerank=64,
        banks=banks, deferred=deferred, keep2=keep2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=SCORE_ATOL)


@settings(max_examples=50, deadline=None)
@given(q8=hnp.arrays(np.int8, (4, 384), elements=st.integers(-127, 127)))
def test_deferred_operands_are_exact_in_16_bit_floats(q8):
    """What K4's bit equality in deferred mode rests on, at D = 384. The
    operands of `_int4_query_operands` are integers that bf16 holds exactly
    (the wrapper rounds them to it) and f16 too (at most 8 significant
    bits, below 65,504), in1 is q_lo itself, and against the widest packed
    row (|b| <= 119, |hi| <= 7) the sum of the products' magnitudes stays
    below 2^24: every partial sum is an integer that float32 holds, in any
    order. Shift mode's integer dot has the same bound."""
    # Queries whose int8 quantization is q8 itself: a row's absmax is 127.
    q = q8.astype(np.float32)
    q[:, 0] = 127.0
    q8 = q.astype(np.int8)
    in1, in2 = ft._int4_query_operands(torch.from_numpy(q), deferred=True)
    q_lo, q_hi = ft._int4_query_operands(torch.from_numpy(q), deferred=False)
    np.testing.assert_array_equal(q_lo.numpy(), q8[:, :192])
    np.testing.assert_array_equal(q_hi.numpy(), q8[:, 192:])
    for op in (in1, in2):
        assert torch.equal(op, op.round())
        assert torch.equal(op.to(torch.bfloat16).float(), op)
        assert torch.equal(op.to(torch.float16).float(), op)
    assert torch.equal(in1, q_lo.float())
    assert in2.abs().max() <= 127 + 16 * 127 + 8  # 2,159 rounds to 2,160
    worst = 119 * in1.abs().sum(dim=1) + 7 * in2.abs().sum(dim=1)
    assert worst.max() < 2 ** 24
    assert (7 * torch.from_numpy(np.abs(q8.astype(np.int64))).sum(dim=1)).max() < 2 ** 24


def test_int4_wrappers_reject_what_they_cannot_take():
    p = torch.zeros((2048, D // 2), dtype=torch.int8)
    scales = torch.ones(2048)
    with pytest.raises(ValueError):  # queries of the packed width, not the row width
        ft.int4q_candidates(p, scales, torch.zeros((2, D // 2)))
    with pytest.raises(TypeError):
        ft.int4q_candidates(p.float(), scales, torch.zeros((2, D)))
    with pytest.raises(ValueError):  # CPU tensors never reach a kernel
        ft.int4q_candidates_cuda(p, scales, torch.zeros((2, D)))


def test_cpu_tensors_never_count_as_int4_launches():
    rng, _, p, codes, scales = _corpus(1, 2048)
    before = dict(ft.LAUNCHES)
    ft.fused_score_topk_int4_rerank(torch.from_numpy(p), torch.from_numpy(scales),
                                    torch.from_numpy(codes), torch.from_numpy(_unit(rng, 2)), 4)
    assert ft.LAUNCHES == before
