"""Device dispatch for flash attention: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``).  There is no fallback between the two.

Unlike the reference's wrapper (``repro/kernels/flash_attention/ops.py``),
the head dim is not padded to 128 lanes: that is a TPU layout matter.  The
scale is ``1/sqrt(hd)`` of the true head dim, as there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,T,hd]; k,v: [B,KV,S,hd] -> [B,H,T,hd].  ``q_offset`` (a host
    int, default ``S - T``) is the absolute position of query row 0: the
    chunked prefill passes the segment start."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    if q.is_cuda:
        return K.launch(q, k, v, causal=causal, window=window,
                        q_offset=int(q_offset), scale=scale)
    return R.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
