"""Plain PyTorch versions of the blur kernels (zero boundary semantics:
images carry a 1-pixel zero pad ring that is never written).

They repeat the CUDA kernel's arithmetic on 9 shifted views: median by the
same min/max exchange network (bitwise equal to the reference), gaussian
by the same s0..s8 sum with pre-divided weights.  The CPU path and the
tests use them; on the card they are what the kernel is held against.
"""
from __future__ import annotations

import torch

_GAUSS = (1., 2., 1., 2., 4., 2., 1., 2., 1.)


def _shifts(img: torch.Tensor):
    """img: padded [R+2, W+2] -> the 9 interior-aligned shifts [R, W]."""
    r = img.shape[0] - 2
    w = img.shape[1] - 2
    return [img[di:di + r, dj:dj + w] for di in range(3) for dj in range(3)]


def median9(v):
    """v: list of 9 tensors -> elementwise median via the branch-free
    odd-even transposition network (9 passes of min/max exchanges)."""
    p = list(v)
    n = len(p)
    for pass_ in range(n):
        for i in range(pass_ % 2, n - 1, 2):
            p[i], p[i + 1] = (torch.minimum(p[i], p[i + 1]),
                              torch.maximum(p[i], p[i + 1]))
    return p[n // 2]


def gaussian9(v):
    acc = v[0] * (_GAUSS[0] / 16.0)
    for si, wi in zip(v[1:], _GAUSS[1:]):
        acc = acc + si * (wi / 16.0)
    return acc


def blur_block(block: torch.Tensor, kind: str) -> torch.Tensor:
    """block: padded [RB+2, W+2] -> blurred interior [RB, W]."""
    if kind not in ("median", "gaussian"):
        raise ValueError(f"unknown blur kind {kind!r}")
    s = _shifts(block)
    return median9(s) if kind == "median" else gaussian9(s)


def blur_ref(img: torch.Tensor, kind: str) -> torch.Tensor:
    """One whole-image pass: padded [H+2, W+2] in, padded out with the
    interior replaced and the zero ring preserved."""
    out = torch.zeros_like(img)
    out[1:-1, 1:-1] = blur_block(img, kind)
    return out


def iterated_blur_ref(img: torch.Tensor, iters: int, kind: str) -> torch.Tensor:
    for _ in range(iters):
        img = blur_ref(img, kind)
    return img
