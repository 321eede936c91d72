"""Plain reference of the paper's blur task set (MedianBlur, GaussianBlur).

A frame is a padded ``[H + 2, W + 2]`` float32 array whose one-pixel ring
is zero and never written; a pass replaces every interior pixel by the
median (MedianBlur) or the 3x3 binomial weighted mean (GaussianBlur) of
its 3x3 neighbourhood, and a task of ``iters`` iterations applies the pass
that many times.  The median is taken with ``torch.sort`` over the nine
shifted views (exact, whatever the order of the data); the gaussian is the
plain weighted sum.  Nothing here comes from the program under test.
"""
from __future__ import annotations

import torch

GAUSS = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _neighbours(img: torch.Tensor) -> torch.Tensor:
    """``[9, H, W]``: the 3x3 neighbourhood of every interior pixel."""
    h, w = img.shape[0] - 2, img.shape[1] - 2
    return torch.stack([img[i:i + h, j:j + w]
                        for i in range(3) for j in range(3)])


def blur_pass(img: torch.Tensor, kind: str) -> torch.Tensor:
    """One pass over a padded frame; the ring stays zero."""
    nb = _neighbours(img)
    if kind == "median":
        inner = torch.sort(nb, dim=0).values[4]
    elif kind == "gaussian":
        inner = torch.zeros_like(nb[0])
        for idx in range(9):
            inner = inner + nb[idx] * (GAUSS[idx // 3][idx % 3] / 16.0)
    else:
        raise ValueError(f"unknown blur kind {kind!r}")
    out = torch.zeros_like(img)
    out[1:-1, 1:-1] = inner
    return out


def blur_task(frame: torch.Tensor, kind: str, iters: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The image a task of ``iters`` passes leaves, as float32.  ``dtype``
    is the precision the passes run in: float32 is the reference, a lower
    one is the control."""
    img = frame.to(dtype)
    for _ in range(iters):
        img = blur_pass(img, kind)
    return img.float()
