"""Plain PyTorch version of the RG-LRU scan kernel.

The reference's oracle (``repro/kernels/rglru_scan/ref.py``) as a loop
over time: ``h_t = a_t * h_{t-1} + b_t`` per channel, in float32.  The CPU
path and the tests use it; on the card it is what the CUDA kernel is held
against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: [B,T,L]; h0: [B,L] or None (zeros).  Returns (h_seq [B,T,L]
    f32, h_last [B,L] f32)."""
    a, b = a.float(), b.float()
    h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h
