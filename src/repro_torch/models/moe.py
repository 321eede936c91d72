"""Mixture-of-Experts FFN with gather-based (capacity) dispatch: the port
of the single-device path of the reference's ``repro/models/moe.py``.

Every token is routed to its top-k experts with capacity
C = ceil(k * N / E * cf) (padded to a multiple of 8); a token whose expert
is full is dropped for that choice.  Gather-based dispatch keeps the
FLOPs proportional to the active parameters (2 * E*C * D * F per matmul).
The aux loss is the Switch-style load balance the LM's loss weighs with
``AUX_WEIGHT``.

On one card there is no mesh: ``moe_ffn`` runs ``moe_ffn_local`` whole.
The reference's expert-parallel functions (``moe_ep_ffn_local``,
``moe_ep_ffn``, ``_ep_decode_local``, ``moe_ffn_decode_ep``) and
``MOE_MODE``, which chooses between them and the TP layout, exist only
inside ``shard_map`` and come with the port's pod tooling.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

TOKEN_CHUNK = 16384  # cap on tokens dispatched at once


def router_topk(x2d: torch.Tensor, router_w: torch.Tensor, moe: MoEConfig):
    """x2d: [N, D] -> (topk_idx [N,k], topk_w [N,k], (me [E], ce [E],
    count)): the router's top-k and the load-balance sums."""
    logits = x2d.float() @ router_w.float()  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, moe.top_k, dim=-1)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    me = torch.sum(probs, dim=0)  # [E] sum of router probs
    ce = torch.sum(F.one_hot(topk_idx[:, 0], moe.n_experts).float(),
                   dim=0)  # [E] top-1 assignment counts
    cnt = torch.tensor(float(x2d.shape[0]), device=x2d.device)
    return topk_idx, topk_w, (me, ce, cnt)


def local_capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(math.ceil(moe.top_k * n_tokens / moe.n_experts
                      * moe.capacity_factor))
    return max(8, -(-c // 8) * 8)  # padded to 8, as the reference


def dispatch_indices(topk_idx: torch.Tensor, E: int, C: int):
    """Gather/scatter indices for capacity-C dispatch.

    Returns (slot_token [E*C] token index feeding each expert slot,
             slot_valid [E*C] bool,
             dest [N, k] destination slot per (token, choice) — E*C means
             dropped)."""
    N, k = topk_idx.shape
    dev = topk_idx.device
    flat_e = topk_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # slots sorted by expert
    sorted_e = flat_e[order]
    # rank of each sorted slot within its expert group
    pos = torch.arange(N * k, device=dev)
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(E, device=dev,
                                                dtype=sorted_e.dtype),
                                   side="left")
    rank = pos - seg_start[sorted_e]
    dest_sorted = torch.where(rank < C, sorted_e * C + rank,
                              torch.full_like(rank, E * C))
    dest = torch.empty(N * k, dtype=torch.long, device=dev)
    dest[order] = dest_sorted
    token_of_flat = torch.div(pos, k, rounding_mode="floor")
    slot_token = torch.full((E * C + 1,), N, dtype=torch.long, device=dev)
    # dropped choices all write the spare slot E*C, which is cut off
    slot_token[dest] = token_of_flat
    slot_valid = slot_token[:E * C] < N
    return slot_token[:E * C], slot_valid, dest.reshape(N, k)


def moe_ffn_local(x: torch.Tensor, p: dict, moe: MoEConfig):
    """MoE SwiGLU FFN.  x: [B, T, D]; ``p``: router [D,E], w1 [E,D,F], w3
    [E,D,F], w2 [E,F,D].  Sequences longer than TOKEN_CHUNK tokens are
    dispatched a chunk at a time, as the reference, so the [E, C, D] gather
    buffers stay bounded.  Returns (y [B,T,D], aux_loss scalar)."""
    B, T, D = x.shape
    N_all = B * T
    if N_all > TOKEN_CHUNK and N_all % TOKEN_CHUNK == 0:
        ys, auxs = [], []
        for xi in x.reshape(N_all // TOKEN_CHUNK, 1, TOKEN_CHUNK, D):
            yi, auxi = _moe_dispatch_compute(xi, p, moe)
            ys.append(yi)
            auxs.append(auxi)
        return torch.stack(ys).reshape(B, T, D), torch.mean(torch.stack(auxs))
    return _moe_dispatch_compute(x, p, moe)


def _moe_dispatch_compute(x: torch.Tensor, p: dict, moe: MoEConfig):
    B, T, D = x.shape
    E, k = moe.n_experts, moe.top_k
    N = B * T
    C = local_capacity(N, moe)
    x2d = x.reshape(N, D)

    topk_idx, topk_w, (me, ce, cnt) = router_topk(x2d, p["router"], moe)
    slot_token, _, dest = dispatch_indices(topk_idx, E, C)

    # gather tokens into expert slots (dropped slots read a zero row)
    x_pad = torch.cat([x2d, x2d.new_zeros((1, D))], dim=0)
    xe = x_pad[slot_token].reshape(E, C, D)

    h = torch.einsum("ecd,edf->ecf", xe, p["w1"])
    g = torch.einsum("ecd,edf->ecf", xe, p["w3"])
    h = F.silu(h) * g
    ye = torch.einsum("ecf,efd->ecd", h, p["w2"])

    # combine back: y[token] += w * ye[slot]
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))], dim=0)
    contrib = ye_flat[dest.reshape(-1)].reshape(N, k, D)
    y = torch.sum(contrib * topk_w[..., None].to(contrib.dtype), dim=1)

    # aux load-balance loss: E * mean(me_frac * ce_frac)
    denom = torch.clamp(cnt, min=1.0)
    aux = E * torch.sum((me / denom) * (ce / denom))
    return y.reshape(B, T, D).to(x.dtype), aux


def moe_ffn(x: torch.Tensor, p: dict, moe: MoEConfig):
    """The reference's ``moe_ffn`` with ``mesh=None``: every expert on the
    one card.  x: [B, T, D].  Returns (y, aux_loss)."""
    return moe_ffn_local(x, p, moe)


def init_moe_params(d_model: int, d_ff: int, moe: MoEConfig, *,
                    generator: Optional[torch.Generator], device,
                    dtype=torch.float32, n: Optional[int] = None) -> dict:
    """The reference's initialisation laws, drawn from ``generator`` on
    ``device``: with ``n``, each tensor is one stacked ``[n, ...]`` draw."""
    E = moe.n_experts
    lead = () if n is None else (n,)

    def normal(shape, std, dt=dtype):
        return torch.empty(lead + shape, dtype=dt, device=device).normal_(
            0.0, std, generator=generator)

    return {
        "router": normal((d_model, E), 0.02, torch.float32),
        "w1": normal((E, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w3": normal((E, d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "w2": normal((E, d_ff, d_model), 1.0 / math.sqrt(d_ff)),
    }
