"""Plain PyTorch version of the flash-attention kernel.

It computes the function of the reference's Pallas kernel
(``repro/kernels/flash_attention/kernel.py``), not its tiling: a direct
softmax over the masked scores, with the kernel's constants — masked
scores are ``NEG_INF``, the row max is clamped at ``-0.5e30`` and the
denominator floored at ``1e-30`` — so a fully masked row outputs 0, as the
kernel's does (the reference's own ``ref.py`` oracle gives the mean of
``v`` there).  The CPU path and the tests use it; on the card it is what
the CUDA kernel is held against.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
MAX_FLOOR = -0.5e30
DENOM_FLOOR = 1e-30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,T,hd]; k,v: [B,KV,S,hd] with H % KV == 0 -> [B,H,T,hd] in
    q's dtype.  ``q_offset`` is the absolute position of query row 0
    (default ``S - T``)."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_offset = S - T if q_offset is None else int(q_offset)
    kx = k.float().repeat_interleave(g, dim=1)
    vx = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float() * scale, kx.transpose(-1, -2))  # [B,H,T,S]
    q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= q_pos - k_pos < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(MAX_FLOOR)
    p = torch.exp(s - m)
    o = torch.matmul(p, vx) / p.sum(dim=-1, keepdim=True).clamp_min(
        DENOM_FLOOR)
    return o.to(q.dtype)
