"""Plain PyTorch versions of the decode-attention kernel.

They compute the function of the reference's Pallas ``_dec_kernel``
(``repro/kernels/decode_attention/kernel.py``): one query row per (batch,
head) against a ring cache whose slot i holds absolute position
``last - ((last - i) mod S)``, ``last = pos - 1``; a key is valid when
``0 <= k_pos <= pos - 1`` (and inside the optional window).  The kernel's
constants are kept — masked scores ``NEG_INF``, max clamped at ``-0.5e30``,
denominator floored at ``1e-30`` — so a row with ``pos = 0`` outputs 0.
``paged_decode_attention`` gathers the pages into the dense cache first, as
the reference's ``ops.paged_decode_attention`` does, so on the CPU paged
equals gather-plus-contiguous by construction.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
MAX_FLOOR = -0.5e30
DENOM_FLOOR = 1e-30


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (an int or i32[B]) as an int32 [B] tensor on ``device``."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        return pos.to(device=device, dtype=torch.int32)
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,1,hd]; caches [B,KV,S,hd]; pos int or i32[B] (tokens
    written, current one included) -> [B,H,1,hd] in q's dtype."""
    B, H, _, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    last = row_positions(pos, B, q.device).long()[:, None] - 1      # [B,1]
    slot = torch.arange(S, device=q.device)[None, :]
    k_pos = last - torch.remainder(last - slot, S)                   # [B,S]
    ok = (k_pos >= 0) & (k_pos <= last)
    if window is not None:
        ok &= last - k_pos < window
    kx = k_cache.float().repeat_interleave(g, dim=1)                 # [B,H,S,hd]
    vx = v_cache.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float() * scale, kx.transpose(-1, -2))        # [B,H,1,S]
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(MAX_FLOOR)
    p = torch.exp(s - m)
    o = torch.matmul(p, vx) / p.sum(dim=-1, keepdim=True).clamp_min(
        DENOM_FLOOR)
    return o.to(q.dtype)


def gather_kv_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pool [NB,BS,KV,hd], tables i32[B,T_blk] -> the dense per-row cache
    [B,KV,T_blk*BS,hd], pages laid out in table order."""
    NB, BS, KV, hd = pool.shape
    B, T_blk = tables.shape
    pages = pool[tables.long()]                                      # [B,T_blk,BS,KV,hd]
    return pages.reshape(B, T_blk * BS, KV, hd).permute(0, 2, 1, 3)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor, pos,
                           *, window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,1,hd]; pools [NB,BS,KV,hd]; tables i32[B,T_blk]; pos i32[B]
    -> [B,H,1,hd]."""
    return decode_attention(q, gather_kv_pages(k_pool, tables),
                            gather_kv_pages(v_pool, tables), pos,
                            window=window, scale=scale)
