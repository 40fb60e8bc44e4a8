"""The frozen FLOP and byte formulas against counts made by hand."""

import pytest

from perfbench import arith


def test_encoder_flops_at_256():
    # 12 layers x (4 projections 2*384*384 + FFN 2*2*384*1536 + attention 2*2*256*384)
    per_layer = 4 * 2 * 384 * 384 + 2 * 2 * 384 * 1536 + 2 * 2 * 256 * 384
    assert arith.encoder_flops_per_token(256) == 12 * per_layer
    assert arith.encoder_flops_per_token(256) == pytest.approx(47.19e6, rel=1e-3)
    assert arith.encoder_flops([256]) == pytest.approx(12.08e9, rel=1e-3)


def test_encoder_flops_sum_of_lengths():
    assert arith.encoder_flops([8, 30]) == 8 * arith.encoder_flops_per_token(8) \
        + 30 * arith.encoder_flops_per_token(30)


def test_k2_bytes_and_bound():
    # 1M rows of 384 int8 codes and a float32 scale, 1M alive entries,
    # 128 int8 queries with scales, a 128 x 512 bank of (value, row).
    n = 1 << 20
    b = n * 388 + n * 4 + 128 * 388 + 128 * 512 * 8
    assert arith.k2_bytes(128, n, n) == b
    assert arith.k2_bound_s(128, n, n) == pytest.approx(b / 3.35e12)  # bytes bind


def test_k5_bytes_and_bound():
    live, chunks, C = 1_000_000, 1200, 4096
    b = live * 388 + chunks * 4 + C * 4 + 128 * 384 * 4 + 128 * 1024 * 8
    assert arith.k5_bytes(128, live, chunks, C) == b
    ops = 2.0 * 128 * live * 384
    assert arith.k5_bound_s(128, live, chunks, C) == pytest.approx(max(b / 3.35e12, ops / 989e12))


def test_peaks():
    assert arith.HBM_BYTES_PER_S == 3.35e12
    assert arith.PEAK_OPS_PER_S == {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def _reader(name):
    from perfbench.run import reader

    return reader(name)


def test_probed_rows_reader_is_the_window_mean():
    assert _reader("probed_rows.ivf")({"probed_rows": [100, 300]}) == 200
    assert _reader("probed_rows.ivf")({"probed_rows": []}) is None
