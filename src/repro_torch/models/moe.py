"""Mixture-of-Experts FFN with gather-based (capacity) dispatch: the port
of the reference's ``repro/models/moe.py``.

Every token is routed to its top-k experts with capacity
C = ceil(k * N / E * cf) (padded to a multiple of 8); a token whose expert
is full is dropped for that choice.  Gather-based dispatch keeps the
FLOPs proportional to the active parameters (2 * E*C * D * F per matmul).
The aux loss is the Switch-style load balance the LM's loss weighs with
``AUX_WEIGHT``.

Over a mesh, dispatch is local per data shard: each data shard routes its
own tokens with local capacity.  The per-shard bodies (``_moe_local``,
``moe_ep_ffn_local``, ``_ep_decode_local``) are generators that yield
their collectives, run by ``sharding.spmd.shard_map`` on either binding;
``moe_ffn_local`` runs the first alone, on one device.  ``MOE_MODE``
chooses the layout, as in the reference: "tp" (every shard computes all
experts, d_ff over "model") or "ep_decode" (experts stationary, E over
"model" and F over "data", for one-token decode).

The reference's ``moe_ep_ffn_local`` reshapes its first all-to-all's
``[e_loc, C, n_ep, D]`` result as if it were ``[e_loc, n_ep, C, D]``,
which scrambles the expert slots (ROADMAP §C).  The port moves the source
axis first, so ``moe_ep_ffn`` equals ``moe_ffn_local`` per data shard.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import MoEConfig
from repro_torch.sharding.spmd import (P, all_to_all, axis_index, mesh_shape,
                                       psum, run_alone, shard_map)

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
    """MoE SwiGLU FFN on one device.  x: [B, T, D]; ``p``: router [D,E],
    w1 [E,D,F], w3 [E,D,F], w2 [E,F,D].  Sequences longer than TOKEN_CHUNK
    tokens are dispatched a chunk at a time, as the reference, so the
    [E, C, D] gather buffers stay bounded.  Returns (y [B,T,D], aux_loss
    scalar)."""
    return run_alone(_moe_local(x, p, moe))


def _moe_local(x, p, moe: MoEConfig, model_axis: Optional[str] = None,
               data_axes: Optional[tuple] = None):
    """The body of ``moe_ffn_local`` (F may be the model-axis shard): psum
    of the expert output over ``model_axis`` and of the aux sums over
    ``data_axes`` where given."""
    B, T, D = x.shape
    N_all = B * T
    if N_all > TOKEN_CHUNK and N_all % TOKEN_CHUNK == 0:
        ys, auxs = [], []
        for xi in x.reshape(N_all // TOKEN_CHUNK, 1, TOKEN_CHUNK, D):
            yi, auxi = yield from _moe_dispatch_compute(xi, p, moe,
                                                        model_axis, data_axes)
            ys.append(yi)
            auxs.append(auxi)
        return torch.stack(ys).reshape(B, T, D), torch.mean(torch.stack(auxs))
    return (yield from _moe_dispatch_compute(x, p, moe, model_axis,
                                             data_axes))


def _experts(xe: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU of every expert's slots: xe [e, C, D] -> [e, C, D]."""
    h = torch.einsum("ecd,edf->ecf", xe, p["w1"])
    g = torch.einsum("ecd,edf->ecf", xe, p["w3"])
    return torch.einsum("ecf,efd->ecd", F.silu(h) * g, p["w2"])


def _dispatch(x2d: torch.Tensor, p: dict, moe: MoEConfig, C: int):
    """Routing and the gather into expert slots: (xe [E, C, D], dest,
    topk_w, (me, ce, cnt))."""
    N, D = x2d.shape
    topk_idx, topk_w, sums = router_topk(x2d, p["router"], moe)
    slot_token, _, dest = dispatch_indices(topk_idx, moe.n_experts, C)
    # dropped slots read a zero row
    x_pad = torch.cat([x2d, x2d.new_zeros((1, D))], dim=0)
    return x_pad[slot_token].reshape(moe.n_experts, C, D), dest, topk_w, sums


def _combine(ye: torch.Tensor, dest, topk_w) -> torch.Tensor:
    """y[token] = sum over its choices of w * ye[slot]; ye [E, C, D]."""
    E, C, D = ye.shape
    N, k = dest.shape
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))], dim=0)
    contrib = ye_flat[dest.reshape(-1)].reshape(N, k, D)
    return torch.sum(contrib * topk_w[..., None].to(contrib.dtype), dim=1)


def _aux(sums, E: int, data_axes: Optional[tuple]):
    """E * sum(me_frac * ce_frac), global over ``data_axes`` where given
    (one psum of the three sums)."""
    me, ce, cnt = sums
    if data_axes:
        tot = yield psum(torch.cat([me, ce, cnt.reshape(1)]), data_axes)
        me, ce, cnt = tot[:E], tot[E:2 * E], tot[2 * E]
    denom = torch.clamp(cnt, min=1.0)
    return E * torch.sum((me / denom) * (ce / denom))


def _moe_dispatch_compute(x, p, moe: MoEConfig, model_axis=None,
                          data_axes=None):
    B, T, D = x.shape
    C = local_capacity(B * T, moe)
    xe, dest, topk_w, sums = _dispatch(x.reshape(B * T, D), p, moe, C)
    ye = _experts(xe, p)  # partial over the model shard of F
    # free the slots before this shard waits at the psum: on the
    # single-process binding every shard's frame is alive at once
    del xe
    if model_axis is not None:
        ye = yield psum(ye, model_axis)
    y = _combine(ye, dest, topk_w)
    aux = yield from _aux(sums, moe.n_experts, data_axes)
    return y.reshape(B, T, D).to(x.dtype), aux


# "tp" (baseline): every shard computes all experts, d_ff TP over "model".
# "ep_decode": experts stationary -- E over "model", F over "data"; tokens
# replicated (decode batches are KB).
MOE_MODE = "tp"


def _data_axes(mesh) -> tuple:
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def moe_ffn(x: torch.Tensor, p: dict, moe: MoEConfig, mesh=None):
    """x: [B, T, D] with batch sharded over the data-like axes and D
    replicated; expert weights sharded on F over "model" (the reference's
    ``shard_map`` wrapper).  Without a mesh, or on a one-shard mesh, every
    expert runs on the one device; DTensors always take the ``shard_map``
    (its ``torch.distributed`` binding).  Returns (y, aux_loss)."""
    shape = {} if mesh is None else mesh_shape(mesh)
    if math.prod(shape.values()) <= 1 and not isinstance(x, DTensor):
        return moe_ffn_local(x, p, moe)
    if (MOE_MODE == "ep_decode" and x.shape[1] == 1
            and moe.n_experts % shape["model"] == 0):
        return moe_ffn_decode_ep(x, p, moe, mesh)
    data_axes = _data_axes(mesh)
    dp_size = math.prod(shape[a] for a in data_axes)
    # batch-1 long-context decode: replicate over the data axes
    xspec = P(data_axes if x.shape[0] % max(dp_size, 1) == 0 else None,
              None, None)
    pspec = {"router": P(None, None), "w1": P(None, None, "model"),
             "w3": P(None, None, "model"), "w2": P(None, "model", None)}

    def body(xs, ps):
        return _moe_local(xs, ps, moe, "model", data_axes)

    return shard_map(body, mesh, (xspec, pspec), (xspec, P()))(x, p)


# --------------------------------------------------------------------------
# Expert-parallel variant
# --------------------------------------------------------------------------
def moe_ep_ffn_local(x, p, moe: MoEConfig, model_axis: str, data_axes: tuple,
                     n_ep: int):
    """Per-shard body: experts sharded over the model axis (``n_ep`` expert
    groups, each with full d_ff); token blocks are all-to-all'd to their
    expert's shard and back, with no psum of the expert output."""
    B, T, D = x.shape
    E = moe.n_experts
    e_loc = E // n_ep
    N = B * T
    C = local_capacity(N, moe)
    xe, dest, topk_w, sums = _dispatch(x.reshape(N, D), p, moe, C)

    # [n_ep, e_loc, C, D] -> [e_loc, C, n_ep (source), D] -> [e_loc,
    # n_ep*C, D]: the source axis goes before the slots (ROADMAP §C)
    xr = yield all_to_all(xe.reshape(n_ep, e_loc, C, D), model_axis,
                          split=0, concat=2, tiled=False)
    del xe
    yr = _experts(xr.movedim(2, 1).reshape(e_loc, n_ep * C, D), p)
    del xr
    yr = yr.reshape(e_loc, n_ep, C, D).transpose(0, 1)
    ye = yield all_to_all(yr, model_axis, split=0, concat=0, tiled=True)
    y = _combine(ye.reshape(E, C, D), dest, topk_w)
    aux = yield from _aux(sums, E, data_axes)
    return y.reshape(B, T, D).to(x.dtype), aux


def moe_ep_ffn(x, p, moe: MoEConfig, mesh):
    """Expert-parallel MoE (needs n_experts divisible by the model axis)."""
    data_axes = _data_axes(mesh)
    m = mesh_shape(mesh)["model"]
    n_ep = math.gcd(moe.n_experts, m)
    if n_ep != m:
        raise ValueError(f"EP needs n_experts ({moe.n_experts}) divisible "
                         f"by the model axis ({m})")
    xspec = P(data_axes, None, None)
    pspec = {"router": P(None, None), "w1": P("model", None, None),
             "w3": P("model", None, None), "w2": P("model", None, None)}

    def body(xs, ps):
        return moe_ep_ffn_local(xs, ps, moe, "model", data_axes, n_ep)

    return shard_map(body, mesh, (xspec, pspec), (xspec, P()))(x, p)


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


# --------------------------------------------------------------------------
# Expert-parallel decode
# --------------------------------------------------------------------------
def _ep_decode_local(x, p, moe: MoEConfig, e_per_shard: int):
    """Per-shard body: x replicated [B,1,D]; weights are this shard's
    experts (E_loc over "model") x F-slice (over "data").  Comm per layer:
    psum[E_loc,C,D] over "data" (TP within an expert) + psum[E,C,D] over
    "model" (combine)."""
    B, T, D = x.shape
    E = moe.n_experts
    N = B * T
    C = local_capacity(N, moe)
    xe, dest, topk_w, sums = _dispatch(x.reshape(N, D), p, moe, C)

    m_idx = yield axis_index("model")
    lo = m_idx * e_per_shard
    ye = _experts(xe[lo:lo + e_per_shard], p)  # partial over F ("data")
    del xe
    ye = yield psum(ye, "data")                # full expert output
    # this shard's experts into the global slot table, then combined
    # across expert columns
    ye_all = ye.new_zeros((E, C, D))
    ye_all[lo:lo + e_per_shard] = ye
    ye_all = yield psum(ye_all, "model")
    y = _combine(ye_all, dest, topk_w)
    aux = yield from _aux(sums, E, None)
    return y.reshape(B, T, D).to(x.dtype), aux


def moe_ffn_decode_ep(x, p, moe: MoEConfig, mesh):
    """One-token decode with the experts stationary: E over "model", F over
    "data", tokens replicated."""
    e_per_shard = moe.n_experts // mesh_shape(mesh)["model"]
    pspec = {"router": P(None, None), "w1": P("model", None, "data"),
             "w3": P("model", None, "data"), "w2": P("model", "data", None)}

    def body(xs, ps):
        return _ep_decode_local(xs, ps, moe, e_per_shard)

    rep = P(None, None, None)
    return shard_map(body, mesh, (rep, pspec), (rep, P()))(x, p)
