"""Device dispatch for the blur kernels: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``).  There is no fallback between the two."""
from __future__ import annotations

import torch

from repro_torch.kernels.blur import kernel as K
from repro_torch.kernels.blur import ref as R


def blur_block(block: torch.Tensor, kind: str = "median") -> torch.Tensor:
    """block: padded [RB+2, W+2] -> blurred interior [RB, W]."""
    if block.is_cuda:
        return K.blur_block(block, kind)
    return R.blur_block(block, kind)


def blur_rows(src_padded: torch.Tensor, dst_padded: torch.Tensor,
              row_block: int, r: int, kind: str):
    """Blur rows [r*RB, (r+1)*RB) of the padded image ``src_padded`` into
    the same rows of ``dst_padded`` (in place, interior columns only)."""
    row0 = r * row_block
    if src_padded.is_cuda:
        K.blur_rows(src_padded, dst_padded, row0, row_block, kind)
        return
    w = src_padded.shape[1] - 2
    dst_padded[row0 + 1:row0 + row_block + 1, 1:w + 1] = R.blur_block(
        src_padded[row0:row0 + row_block + 2], kind)
