"""The arithmetic of benchmark/roofline.py."""

import pytest

from benchmark import roofline


def test_least_time_takes_the_slower_peak():
    assert roofline.least_time(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_time(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_time(989e12, 6.7e12) == pytest.approx(2.0)
    assert roofline.bound_by(989e12, 1.0) == "operations"
    assert roofline.bound_by(1.0, 3.35e12) == "bytes"


def test_mf_epoch_work():
    f, b = roofline.mf_epoch_work(1000, 10, 20, 8)
    assert f == 10 * 8 * 1000
    assert b == 8 * 1000 + 8 * 11 + 2 * 4 * 8 * 30


def test_mf_epoch_work_at_ml20m_is_bytes_bound():
    # 17.0M ratings, 138,493 x 26,744 at rank 64: about 222 MB, 66 us
    f, b = roofline.mf_epoch_work(17_000_000, 138_493, 26_744, 64)
    assert roofline.bound_by(f, b) == "bytes"
    assert 2.1e8 < b < 2.3e8
    assert 6.3e-5 < roofline.least_time(f, b) < 6.9e-5


def test_bpr_epoch_work():
    f, b = roofline.bpr_epoch_work(100, 5, 7, 4)
    assert f == 15 * 4 * 100
    assert b == 8 * 100 + 8 * 6 + 2 * 4 * 4 * 12


def test_topn_work():
    f, b = roofline.topn_work(3, 50, 8, 40, 10)
    assert f == 2 * 8 * 3 * 50
    assert b == 4 * 8 * 53 + 4 * 40 + 16 * 3 + 80 * 3
