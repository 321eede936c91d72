"""RWKV-6 "Finch" time-mix and channel-mix: the port of the reference's
``repro/models/rwkv.py``.

Recurrent form (per head):

    o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)         # readout with bonus u
    S_t = diag(w_t) S_{t-1} + k_t v_t^T             # state update

with w_t = exp(-exp(d_t)), d_t a data-dependent (LoRA) decay.  The
recurrence of ``rwkv_time_mix`` runs in ``kernels.rwkv6`` for every
sequence length: on the card the hand-written CUDA kernel, on the CPU its
plain version.  The reference's prefill takes its chunked-parallel form
(chunks of 64), which agrees with the recurrence to about 4e-6 in the
logits; that form (``rwkv_time_mix_chunked``) is the training path's and
comes with the training slice.  ``rwkv_time_mix_scan`` is the reference's
step-by-step oracle, kept here in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6 import ref as rwkv6_ref


def token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """x: [B,T,D]; x_prev: [B,D] last token of the previous segment.
    Returns x shifted right by one along T."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                             device=x.device)
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def rwkv_projections(x: torch.Tensor, x_prev, p: dict, n_heads: int,
                     head_dim: int):
    """r, k, v, g and the log-decay logw (<= 0).  Returns per-head tensors
    [B,T,H,hd] (g as [B,T,H*hd])."""
    B, T, D = x.shape
    xs = token_shift(x, x_prev)
    r = _mix(x, xs, p["mu_r"]) @ p["wr"]
    k = _mix(x, xs, p["mu_k"]) @ p["wk"]
    v = _mix(x, xs, p["mu_v"]) @ p["wv"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["wg"])
    dx = _mix(x, xs, p["mu_w"])
    d = p["w_bias"] + torch.tanh(dx @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(d.float())  # <= 0

    def hsplit(t):
        return t.reshape(B, T, n_heads, head_dim)

    return hsplit(r), hsplit(k), hsplit(v), g, hsplit(logw)


def rwkv_time_mix_scan(r, k, v, logw, u, s0=None):
    """Oracle: step-by-step recurrence.  r,k,v,logw: [B,T,H,hd]; u: [H,hd].
    Returns (o [B,T,H,hd], s_last [B,H,hd,hd])."""
    return rwkv6_ref.rwkv6(r, k, v, logw, u, s0)


def group_norm_heads(o: torch.Tensor, scale: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """RWKV's per-head group norm on the time-mix output.  o: [B,T,H,hd]."""
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)  # as jnp.var
    y = (o - mu) * torch.rsqrt(var + eps)
    B, T, H, hd = o.shape
    return y.reshape(B, T, H * hd) * scale


def rwkv_time_mix(x, p, n_heads, head_dim, x_prev=None, s0=None):
    """Full time-mix sublayer on (pre-normed) x: [B,T,D].
    Returns (y [B,T,D], (x_last [B,D], s_last))."""
    # g is computed and, as in the reference, not applied
    r, k, v, _g, logw = rwkv_projections(x, x_prev, p, n_heads, head_dim)
    o, s_last = ops.rwkv6(r, k, v, logw, p["u"].float(), s0)
    y = group_norm_heads(o.to(x.dtype), p["ln_x"]) @ p["wo"]
    return y, (x[:, -1, :], s_last)


def rwkv_channel_mix(x, p, x_prev=None):
    """Channel-mix sublayer (squared-ReLU MLP with token shift).
    Returns (y, x_last)."""
    xs = token_shift(x, x_prev)
    xk = _mix(x, xs, p["mu_c"])
    h = torch.square(F.relu(xk @ p["cm_w1"]))
    return h @ p["cm_w2"], x[:, -1, :]


def init_rwkv_params(d_model: int, d_ff: int, n_heads: int, head_dim: int,
                     *, generator: torch.Generator, device,
                     dtype=torch.float32, n: Optional[int] = None) -> dict:
    """The reference's initialisation laws, drawn from ``generator`` on
    ``device``: with ``n``, each tensor is one stacked ``[n, ...]`` draw."""
    s = 1.0 / math.sqrt(d_model)
    hh = n_heads * head_dim
    lead = () if n is None else (n,)

    def mat(shape, std=s, dt=dtype):
        return torch.empty(lead + shape, dtype=dt, device=device).normal_(
            0.0, std, generator=generator)

    def full(size, value):
        return torch.full(lead + (size,), value, dtype=torch.float32,
                          device=device)

    return {
        "mu_r": full(d_model, 0.5),
        "mu_k": full(d_model, 0.5),
        "mu_v": full(d_model, 0.5),
        "mu_g": full(d_model, 0.5),
        "mu_w": full(d_model, 0.5),
        "mu_c": full(d_model, 0.5),
        "wr": mat((d_model, hh)),
        "wk": mat((d_model, hh)),
        "wv": mat((d_model, hh)),
        "wg": mat((d_model, hh)),
        "wo": mat((hh, d_model)),
        "w_lora_a": mat((d_model, 64), 0.02),
        "w_lora_b": mat((64, hh), 0.02),
        "w_bias": full(hh, -0.6),
        "u": mat((n_heads, head_dim), 0.1, torch.float32),
        "ln_x": full(hh, 1.0),
        "cm_w1": mat((d_model, d_ff)),
        "cm_w2": mat((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
    }
