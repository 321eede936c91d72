"""RG-LRU recurrent block (RecurrentGemma / Griffin): the port of the
reference's ``repro/models/rglru.py``.

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)  has
two routes:

- serving (``chunked=False``, the default): ``kernels.rglru_scan`` for
  every sequence length, the one-token decode step included; on the card
  the hand-written CUDA scan (B4), on the CPU its plain version.  B4
  records no gradient, and its wrapper raises if asked to differentiate;
- training (``chunked=True``, what ``models/lm.py``'s loss asks for): the
  reference's chunked associative scan in plain differentiable PyTorch: a
  loop over chunks of 256 carrying the boundary state, and within a chunk
  an inclusive scan of log2(chunk) doubling steps (Hillis-Steele) under
  the reference's combine rule; ``a*h0 + bx`` at T == 1, as the reference.
  Its tree of products differs from ``jax.lax.associative_scan``'s, so it
  agrees with the reference to float rounding (held to 1e-5 in the
  tests, the reference's own rglru tolerance).

Gates are per-channel affine, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.rglru_scan import ops
from repro_torch.sharding.spmd import keep_shards, on_shards

C_SCALE = 8.0  # Griffin's fixed temperature on the recurrence gate


def _gates(c: torch.Tensor, p: dict):
    """c: [..., L] conv output -> (a, gated_input)."""
    r = torch.sigmoid(c * p["gate_a_w"] + p["gate_a_b"])  # recurrence gate
    i = torch.sigmoid(c * p["gate_i_w"] + p["gate_i_b"])  # input gate
    log_a = -C_SCALE * F.softplus(p["lambda"]) * r  # [..., L], <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * c)


def _assoc_scan_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """Within-chunk parallel prefix for h_t = a_t h_{t-1} + bx_t.
    a, bx: [B, Cn, L]; h0: [B, L].  Returns (h: [B, Cn, L], h_last)."""
    aa, bb = a, bx
    d, n = 1, a.shape[1]
    while d < n:
        # combine(l, r) = (a_l a_r, b_l a_r + b_r), l the earlier segment
        aa, bb = (torch.cat([aa[:, :d], aa[:, :-d] * aa[:, d:]], dim=1),
                  torch.cat([bb[:, :d], bb[:, :-d] * aa[:, d:] + bb[:, d:]],
                            dim=1))
        d *= 2
    h = bb + aa * h0[:, None, :]
    return h, h[:, -1, :]


def _chunked_scan(a, bx, h0, chunk: int):
    """The reference's chunked scan: chunks of ``chunk`` carrying the
    boundary state.  a, bx: [B, T, L] f32; h0: [B, L]."""
    T = a.shape[1]
    if T == 1:  # decode fast path
        h = a[:, 0] * h0 + bx[:, 0]
        return h[:, None, :], h
    hs, h = [], h0
    for t0 in range(0, T, chunk):
        hs_i, h = _assoc_scan_chunk(a[:, t0:t0 + chunk],
                                    bx[:, t0:t0 + chunk], h)
        hs.append(hs_i)
    return torch.cat(hs, dim=1), h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x: [B, T, L], w: [W, L] depthwise.  state: [B, W-1, L] carried
    inputs.  Returns (y [B,T,L], new_state [B, W-1, L])."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)  # [B, T+W-1, L]
    T = x.shape[1]
    y = sum(xx[:, i:i + T, :] * w[i] for i in range(W))
    new_state = xx[:, -(W - 1):, :] if W > 1 else state
    return y.to(x.dtype), new_state


def rglru_apply(x: torch.Tensor, p: dict, *,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                chunk: int = 256, chunked: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] (post-norm input); h0: [B, L]; conv_state: [B, W-1, L].
    Returns (y [B,T,D], h_last [B,L], conv_state).  ``chunked`` takes the
    training route (module docstring); DTensors take it too, each rank on
    its own batch rows and channels (no kernel runs on a DTensor)."""
    u = x @ p["wx"]  # [B, T, L]
    g = F.gelu(x @ p["wg"], approximate="tanh")  # jax.nn.gelu's default
    c, conv_state = causal_conv1d(u, p["conv"], conv_state)
    a, bx = _gates(c.float(), p)
    if h0 is None and (chunked or isinstance(a, DTensor)):
        h0 = torch.zeros((x.shape[0], a.shape[-1]), dtype=torch.float32,
                         device=x.device)
    if isinstance(a, DTensor):
        seq = keep_shards(a.placements, {0: 0, 2: 2})
        rows = keep_shards(a.placements, {0: 0, 2: 1})
        hs, h_last = on_shards(
            lambda a, bx, h0: _chunked_scan(a, bx, h0, chunk),
            a.device_mesh, (seq, seq, rows), (seq, rows), a, bx, h0)
    elif chunked:
        hs, h_last = _chunked_scan(a, bx, h0, chunk)
    else:
        hs, h_last = ops.rglru_scan(a, bx, h0)
    y = (hs.to(x.dtype) * g) @ p["wo"]
    return y, h_last, conv_state


def init_rglru_params(d_model: int, conv_width: int, *,
                      generator: torch.Generator, device,
                      dtype=torch.float32, n: Optional[int] = None) -> dict:
    """The reference's initialisation laws, drawn from ``generator`` on
    ``device``: with ``n``, each tensor is one stacked ``[n, ...]`` draw."""
    lru = d_model
    s = 1.0 / math.sqrt(d_model)
    lead = () if n is None else (n,)

    def normal(shape, std):
        return torch.empty(lead + shape, dtype=dtype, device=device).normal_(
            0.0, std, generator=generator)

    def full(value):
        return torch.full(lead + (lru,), value, dtype=torch.float32,
                          device=device)

    return {
        "wx": normal((d_model, lru), s),
        "wg": normal((d_model, lru), s),
        "conv": normal((conv_width, lru), 0.1),
        # lambda so that a^c lies in (0.9, 0.999), as in Griffin
        "lambda": torch.empty(lead + (lru,), dtype=torch.float32,
                              device=device).uniform_(0.3, 0.8,
                                                      generator=generator),
        "gate_a_w": full(1.0),
        "gate_a_b": full(0.0),
        "gate_i_w": full(1.0),
        "gate_i_b": full(0.0),
        "wo": normal((lru, d_model), s),
    }
