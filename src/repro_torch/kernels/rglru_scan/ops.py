"""Device dispatch for the RG-LRU scan: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``).  There is no fallback between the two; only
an explicit ``plain_versions()`` block runs the plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.native import plain_versions, use_kernel  # noqa: F401
from repro_torch.kernels.rglru_scan import kernel as K
from repro_torch.kernels.rglru_scan import ref as R


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t.  a, b: [B,T,L]; h0: [B,L] or None
    (zeros).  Returns (h_seq [B,T,L] f32, h_last [B,L] f32)."""
    if use_kernel(a):
        return K.launch(a, b, h0)
    return R.rglru_scan(a, b, h0)
