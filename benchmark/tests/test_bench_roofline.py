"""The yardstick's arithmetic on known shapes."""

import pytest

import roofline


def test_k3_dp_is_bound_by_its_stream():
    # 2048 pairs of 2000 rows at W 256: the 2-byte stream dominates
    B, W, rows = 2048, 256, 2048 * 2000
    nbytes = 4 * (3 * B * W + 3 * rows + 2 * B) + 2 * W * rows + 4 * B * W
    assert roofline.k3_dp(B, W, rows) == pytest.approx(nbytes / 3.35e12)
    # above 8192 lanes the cells are 4 bytes
    assert roofline.k3_dp(1, 16384, 100) > roofline.k3_dp(1, 8192, 100) * 1.9


def test_walk_and_tables():
    assert roofline.k3_walk(1, 10, 128, 10) == pytest.approx(
        ((2 * 2 + 8) * 10 + 5 * 10 + 20) / 3.35e12)
    # K1: 60 pairs of 2048 rows at W 128, float32
    B, Q, W = 60, 2048, 128
    t = roofline.k1_tables(1000, B, Q, W, B * 2000, 4)
    assert t == pytest.approx(max((1000 + 4 * B * Q * (3 * W + 1))
                                  / 3.35e12,
                                  40.0 * W * B * 2000 / 67e12))


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
