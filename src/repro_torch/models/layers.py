"""Core transformer layers in plain PyTorch: the port of the reference's
``repro/models/layers.py``.

Attention is the reference's online-softmax computation over query chunks,
with its constants: masked scores get an additive ``NEG_INF``, the row max
is clamped at ``-0.5e30`` and the denominator floored at ``1e-30``, and the
padded rows of the last query chunk carry position -1.  It is plain tensor
code outside any kernel, as in the reference (where it is jnp, not Pallas).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``1 + scale``: the norms' parameters start at zero."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)  # as jnp.var
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: [..., T] integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(2 * half, theta, device=x.device)  # [half]
    ang = positions[..., None].float() * freqs  # [..., T, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if hd > 2 * half:  # odd head_dim tail
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


# --------------------------------------------------------------------------
# Chunked attention
# --------------------------------------------------------------------------
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive mask bias [*, qc, kc] given absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window is not None:
        ok &= diff < window
    zero = torch.zeros((), dtype=torch.float32, device=diff.device)
    return torch.where(ok, zero, NEG_INF)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_positions: Optional[torch.Tensor] = None,
              k_positions: Optional[torch.Tensor] = None,
              kv_mask: Optional[torch.Tensor] = None,
              q_chunk: int = 1024,
              scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention with GQA (H % KV == 0).  q: [B,Tq,H,hd];
    k, v: [B,Tk,KV,hd]; positions [B,T]; kv_mask [B,Tk] bool.  Returns
    [B,Tq,H,hd] in q's dtype."""
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    groups = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Tq, device=dev).expand(B, Tq)
    if k_positions is None:
        k_positions = torch.arange(Tk, device=dev).expand(B, Tk)

    # [B, KV, G, T, hd] layout so a kv head serves its query group
    qg = q.reshape(B, Tq, KV, groups, hd).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)  # [B, KV, Tk, hd]
    vh = v.permute(0, 2, 1, 3)

    nchunks = -(-Tq // q_chunk)
    pad = nchunks * q_chunk - Tq
    if pad:
        qg = F.pad(qg, (0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad), value=-1)

    kv_bias = 0.0
    if kv_mask is not None:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kv_bias = torch.where(kv_mask, zero, NEG_INF)[:, None, None, None, :]

    outs = []
    for ci in range(nchunks):
        sl = slice(ci * q_chunk, (ci + 1) * q_chunk)
        qc = qg[:, :, :, sl]  # [B, KV, G, qc, hd]
        s = torch.einsum("bkgqh,bkth->bkgqt", qc, kh).float() * scale
        bias = _mask_bias(q_positions[:, sl], k_positions, causal, window)
        s = s + bias[:, None, None, :, :] + kv_bias
        m = torch.amax(s, dim=-1, keepdim=True)
        m = torch.clamp(m, min=-0.5e30)  # rows with no valid key
        p = torch.exp(s - m)
        denom = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bkgqt,bkth->bkgqh", p.to(v.dtype), vh).float()
        outs.append(o / torch.clamp(denom, min=1e-30))
    out = torch.cat(outs, dim=3)[:, :, :, :Tq]  # [B, KV, G, Tq, hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd)
    return out.to(q.dtype)


def ring_positions(pos: int, S: int, device=None) -> torch.Tensor:
    """Absolute position held by each ring-buffer slot after ``pos``
    writes: slot ``i`` holds ``pos-1 - ((pos-1 - i) mod S)`` (negative =>
    never written)."""
    i = torch.arange(S, device=device)
    last = pos - 1
    return last - torch.remainder(last - i, S)  # floor mod, as jnp.mod


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a ring-buffered KV cache.  q:
    [B,1,H,hd]; caches [B,S,KV,hd]; ``pos`` (host int) counts the tokens
    written including the current one, whose k/v must already be in the
    ring at absolute position pos-1."""
    B, S, KV, hd = k_cache.shape
    k_pos = ring_positions(pos, S, device=q.device).expand(B, S)
    q_position = torch.full((B, 1), pos - 1, dtype=torch.long,
                            device=q.device)
    return attention(q, k_cache, v_cache, causal=True, window=window,
                     q_positions=q_position, k_positions=k_pos,
                     kv_mask=k_pos >= 0, q_chunk=1, scale=scale)


# --------------------------------------------------------------------------
# FFN
# --------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def sq_relu_mlp(x: torch.Tensor, w1, w2) -> torch.Tensor:
    """RWKV channel-mix style squared-ReLU MLP."""
    return torch.square(F.relu(x @ w1)) @ w2
