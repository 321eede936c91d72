"""The roofline counts against shapes worked by hand (a 600 px image in
its 640 px buffer)."""
from __future__ import annotations

import pytest

from perfbench.roofline import blur, peaks


def test_b1_pass():
    # read 642^2 floats once, write 640^2 once; 38 operations a pixel
    assert blur.pass_work(640, 640, "median") == (
        (642 * 642 + 640 * 640) * 4, 640 * 640 * 38)
    assert blur.pass_work(640, 640, "gaussian")[1] == 640 * 640 * 17
    assert blur.pass_work(640, 640, "median") == (3287056, 15564800)


def test_bound_is_the_larger_term():
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.bound_s(3.35e12, 0, kind) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12, kind) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12, kind) == pytest.approx(2.0)
    assert peaks.bound_s(1, 1, "a card not listed") is None
    # a 640 px median pass is bound by its bytes: 0.981 us against 0.232
    b, ops = blur.pass_work(640, 640, "median")
    assert peaks.bound_s(b, ops, kind) == pytest.approx(3287056 / 3.35e12)
