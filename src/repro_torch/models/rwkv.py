"""RWKV-6 "Finch" time-mix and channel-mix: the port of the reference's
``repro/models/rwkv.py``.

Recurrent form (per head):

    o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)         # readout with bonus u
    S_t = diag(w_t) S_{t-1} + k_t v_t^T             # state update

with w_t = exp(-exp(d_t)), d_t a data-dependent (LoRA) decay.  Two routes:

- serving (``chunked=False``, the default): the recurrence of
  ``rwkv_time_mix`` runs in ``kernels.rwkv6`` for every sequence length,
  on the card the hand-written CUDA kernel (B5), on the CPU its plain
  version.  B5 records no gradient, and its wrapper raises if asked to
  differentiate;
- training (``chunked=True``, what ``models/lm.py``'s loss asks for): the
  reference's chunked-parallel form, ``rwkv_time_mix_chunked`` (chunks of
  64, decay ratios in log space), in plain differentiable PyTorch, and its
  step-by-step scan at T == 1, as the reference chooses.

The two agree to about 4e-6 in the logits.  ``rwkv_time_mix_scan`` is the
reference's step-by-step oracle, kept here in plain PyTorch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6 import ref as rwkv6_ref
from repro_torch.sharding.spmd import keep_shards, on_shards


def token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor]):
    """x: [B,T,D]; x_prev: [B,D] last token of the previous segment.
    Returns x shifted right by one along T."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                             device=x.device)
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _mm(a, w):
    """``a @ w`` in their promoted dtype, as jnp promotes a product's
    operands: the f32 mixing coefficients lift bf16 activations to f32,
    and the bf16 weights follow.  In f32 it is ``a @ w``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def rwkv_projections(x: torch.Tensor, x_prev, p: dict, n_heads: int,
                     head_dim: int):
    """r, k, v and the log-decay logw (<= 0), per-head tensors
    [B,T,H,hd].  The reference also computes the output gate
    g = silu(mix_g @ wg) and never applies it (XLA drops it, and jit the
    unread mu_g/wg arguments); the port does not compute it."""
    B, T, D = x.shape
    xs = token_shift(x, x_prev)
    r = _mm(_mix(x, xs, p["mu_r"]), p["wr"])
    k = _mm(_mix(x, xs, p["mu_k"]), p["wk"])
    v = _mm(_mix(x, xs, p["mu_v"]), p["wv"])
    dx = _mix(x, xs, p["mu_w"])
    d = p["w_bias"] + _mm(torch.tanh(_mm(dx, p["w_lora_a"])), p["w_lora_b"])
    logw = -torch.exp(d.float())  # <= 0

    def hsplit(t):
        return t.reshape(B, T, n_heads, head_dim)

    return hsplit(r), hsplit(k), hsplit(v), hsplit(logw)


def rwkv_time_mix_scan(r, k, v, logw, u, s0=None):
    """Oracle: step-by-step recurrence.  r,k,v,logw: [B,T,H,hd]; u: [H,hd].
    Returns (o [B,T,H,hd], s_last [B,H,hd,hd])."""
    return rwkv6_ref.rwkv6(r, k, v, logw, u, s0)


def rwkv_time_mix_chunked(r, k, v, logw, u, s0=None, chunk: int = 64):
    """Chunked-parallel form, exact (log-space decay ratios): a loop over
    chunks carrying the state, each chunk an attention-like contraction.
    Shapes as in ``rwkv_time_mix_scan``; differentiable."""
    B, T, H, hd = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    n = -(-T // chunk)
    pad = n * chunk - T

    def prep(t):  # [B,T,H,hd] -> [n,B,H,Cn,hd] f32
        t = t.float()
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, n, chunk, H, hd).permute(1, 0, 3, 2, 4)

    r, k, v, logw = prep(r), prep(k), prep(v), prep(logw)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    s, outs = s0, []
    for i in range(n):
        rc, kc, vc, lw = r[i], k[i], v[i], logw[i]  # [B,H,Cn,hd]
        cum = torch.cumsum(lw, dim=2)  # log prod up to & incl t
        total = cum[:, :, -1:, :]
        cum_excl = cum - lw  # log prod up to t-1
        # inter-chunk: o_inter[t] = (r_t * exp(cum[t-1])) . S_in
        r_in = rc * torch.exp(cum_excl)
        o = torch.einsum("bhtk,bhkv->bhtv", r_in, s)
        # intra-chunk: A[t,i] = sum_d r[t,d] k[i,d] exp(cum_excl[t]-cum[i])
        ki = kc * torch.exp(-cum)
        A = torch.einsum("bhtk,bhik->bhti", r_in, ki)
        A = torch.where(mask, A, 0.0)
        o = o + torch.einsum("bhti,bhiv->bhtv", A, vc)
        # current-token bonus
        diag = torch.einsum("bhtk,bhtk->bht", rc, u[:, None, :] * kc)
        o = o + diag[..., None] * vc
        # S_out = diag(exp(total)) S + sum_i exp(total-cum[i]) k_i v_i^T
        kscale = kc * torch.exp(total - cum)
        s = torch.exp(total)[..., 0, :, None] * s + torch.einsum(
            "bhik,bhiv->bhkv", kscale, vc)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, hd)
    return o[:, :T], s


def group_norm_heads(o: torch.Tensor, scale: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """RWKV's per-head group norm on the time-mix output.  o: [B,T,H,hd]."""
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)  # as jnp.var
    y = (o - mu) * torch.rsqrt(var + eps)
    B, T, H, hd = o.shape
    return y.reshape(B, T, H * hd) * scale


def rwkv_time_mix(x, p, n_heads, head_dim, x_prev=None, s0=None,
                  chunked: bool = False, chunk: int = 64):
    """Full time-mix sublayer on (pre-normed) x: [B,T,D].
    Returns (y [B,T,D], (x_last [B,D], s_last)).  ``chunked`` takes the
    training route (module docstring); the reference's default is the
    chunked form, the port's is B5.  DTensors take the plain forms, each
    rank on its own batch rows and heads (no kernel runs on a
    DTensor)."""
    T = x.shape[1]
    r, k, v, logw = rwkv_projections(x, x_prev, p, n_heads, head_dim)
    u = p["u"].float()

    def recurrence(r, k, v, logw, u, s0):
        if T == 1:
            return rwkv_time_mix_scan(r, k, v, logw, u, s0)
        return rwkv_time_mix_chunked(r, k, v, logw, u, s0, chunk=chunk)

    if isinstance(r, DTensor):
        heads = keep_shards(r.placements, {0: 0, 2: 2})
        state = keep_shards(r.placements, {0: 0, 2: 1})
        o, s_last = on_shards(recurrence, r.device_mesh,
                              (heads,) * 4 + (keep_shards(r.placements,
                                                          {2: 0}), state),
                              (heads, state), r, k, v, logw, u, s0)
    elif not chunked:
        o, s_last = ops.rwkv6(r, k, v, logw, u, s0)
    else:
        o, s_last = recurrence(r, k, v, logw, u, s0)
    y = _mm(group_norm_heads(o.to(x.dtype), p["ln_x"]), p["wo"])
    return y, (x[:, -1, :], s_last)


def rwkv_channel_mix(x, p, x_prev=None):
    """Channel-mix sublayer (squared-ReLU MLP with token shift).
    Returns (y, x_last)."""
    xs = token_shift(x, x_prev)
    xk = _mix(x, xs, p["mu_c"])
    h = torch.square(F.relu(_mm(xk, p["cm_w1"])))
    return _mm(h, p["cm_w2"]), x[:, -1, :]


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
