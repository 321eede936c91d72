"""The plain reference: the blur against a direct loop, and its control
(bfloat16 passes) away from it."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import blur

torch.set_num_threads(1)


def _loop_pass(img: np.ndarray, kind: str) -> np.ndarray:
    out = np.zeros_like(img)
    w = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float64) / 16.0
    for i in range(1, img.shape[0] - 1):
        for j in range(1, img.shape[1] - 1):
            nb = img[i - 1:i + 2, j - 1:j + 2].astype(np.float64)
            out[i, j] = (np.median(nb) if kind == "median"
                         else (nb * w).sum())
    return out


@pytest.mark.parametrize("kind,iters", [("median", 1), ("median", 3),
                                        ("gaussian", 1)])
def test_reference_blur_equals_a_direct_loop(kind, iters):
    rng = np.random.default_rng(3)
    img = np.zeros((20, 22), np.float32)
    img[1:-1, 1:-1] = rng.random((18, 20), dtype=np.float32)
    want = img
    for _ in range(iters):
        want = _loop_pass(want, kind)
    got = blur.blur_task(torch.from_numpy(img), kind, iters).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if kind == "median":
        assert np.array_equal(got, want.astype(np.float32))


def test_bfloat16_control_departs():
    rng = np.random.default_rng(4)
    img = torch.zeros(66, 66)
    img[1:-1, 1:-1] = torch.from_numpy(rng.random((64, 64), dtype=np.float32))
    err = (blur.blur_task(img, "median", 2, torch.bfloat16)
           - blur.blur_task(img, "median", 2)).abs().max()
    assert err > 1e-4
