"""Plain PyTorch version of the RWKV-6 recurrence kernel.

The step-by-step recurrence of the reference's ``rwkv_time_mix_scan``
(``repro/models/rwkv.py``), in float32:

    o_t = r_t . (S + (u * k_t) v_t^T);   S = diag(exp(logw_t)) S + k_t v_t^T

The CPU path and the tests use it; on the card it is what the CUDA kernel
is held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logw: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: [B,T,H,hd]; u: [H,hd]; s0: [B,H,hd,hd] or None (zeros).
    Returns (o [B,T,H,hd] f32, s_last [B,H,hd,hd] f32)."""
    B, T, H, hd = r.shape
    r, k, v, logw, u = (t.float() for t in (r, k, v, logw, u))
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    o = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B,H,hdk,hdv]
        o[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[..., :, None] * kv)
        s = torch.exp(logw[:, t])[..., :, None] * s + kv
    return o, s
