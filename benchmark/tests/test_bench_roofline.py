"""The yardstick's counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_continuous_channel_nonzeros_by_hand():
    # exp(-d^2) stays above float32's smallest subnormal to |d| = 10: a
    # band of 21 per row, cut at the two ends
    L = 500
    by_hand = L * 21 - 2 * sum(range(1, 11))
    assert roofline.continuous_nnz(L, 1.0) == by_hand == 10390


def test_step_and_call_counts_by_hand():
    T, N, L = 1_000_000, 500, 500
    macs = 4 * L + 10390 + L
    assert roofline.step_macs(L, 2, 1.0) == macs
    work = roofline.decode_work(T, N, L, 2, 1.0)
    assert work["emission"][0] == 2.0 * T * N * L
    assert work["joint"][0] == 2.0 * T * (2 * L) ** 2
    assert work["smoother"] == (4.0 * macs * T, 4 * (T * L + T * 2 * L))
    it = roofline.em_iter_work(T, N, L, 2, 1.0)
    assert it["statistics"][0] == it["emission"][0] == 2.0 * T * N * L
    assert it["smoother"][1] == 4 * (T * L + T * (L + 2))
    assert "joint" not in it


def test_bound_takes_the_larger_of_the_two():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e9, 3.35e12) == pytest.approx(1.0)
