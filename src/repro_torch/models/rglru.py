"""RG-LRU recurrent block (RecurrentGemma / Griffin): the port of the
reference's ``repro/models/rglru.py``.

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)  runs
in ``kernels.rglru_scan`` for every sequence length, the one-token decode
step included: on the card that is the hand-written CUDA scan, on the CPU
its plain version.  (The reference computes it with a chunked associative
scan, and with ``a*h0 + bx`` at T == 1, which is one step of the same
recurrence.)  Gates are per-channel affine, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops

C_SCALE = 8.0  # Griffin's fixed temperature on the recurrence gate


def _gates(c: torch.Tensor, p: dict):
    """c: [..., L] conv output -> (a, gated_input)."""
    r = torch.sigmoid(c * p["gate_a_w"] + p["gate_a_b"])  # recurrence gate
    i = torch.sigmoid(c * p["gate_i_w"] + p["gate_i_b"])  # input gate
    log_a = -C_SCALE * F.softplus(p["lambda"]) * r  # [..., L], <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * c)


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
                conv_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] (post-norm input); h0: [B, L]; conv_state: [B, W-1, L].
    Returns (y [B,T,D], h_last [B,L], conv_state)."""
    u = x @ p["wx"]  # [B, T, L]
    g = F.gelu(x @ p["wg"], approximate="tanh")  # jax.nn.gelu's default
    c, conv_state = causal_conv1d(u, p["conv"], conv_state)
    a, bx = _gates(c.float(), p)
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
