"""Device dispatch for decode attention: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``).  There is no fallback between the two.

Two entry points, as in the reference (``repro/kernels/decode_attention/
ops.py``): ``decode_attention`` over contiguous ring or linear caches, and
``paged_decode_attention`` over a shared KV block pool and per-row block
tables — on the card the table walk is fused into the kernel instead of a
separate page gather.  The head dim is not padded to 128 lanes.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,1,hd]; caches [B,KV,S,hd]; pos int or i32[B] -> [B,H,1,hd]."""
    if q.is_cuda:
        return K.launch(q, k_cache, v_cache, pos, window=window,
                        scale=_scale(q, scale))
    return R.decode_attention(q, k_cache, v_cache, pos, window=window,
                              scale=_scale(q, scale))


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor, pos,
                           *, window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,1,hd]; pools [NB,BS,KV,hd] (page 0 = the null page); tables
    i32[B,T_blk]; pos int or i32[B] -> [B,H,1,hd]."""
    if q.is_cuda:
        return K.launch_paged(q, k_pool, v_pool, tables, pos, window=window,
                              scale=_scale(q, scale))
    return R.paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                    window=window, scale=_scale(q, scale))
