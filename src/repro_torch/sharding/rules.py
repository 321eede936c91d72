"""Sharding rules: parameter / optimizer-state / batch / cache partition
specs; the port of the reference's ``repro/sharding/rules.py``, rule for
rule.

Conventions (megatron-style TP + DP):
- vocab & FFN hidden (d_ff / expert d_ff / lru width / rwkv heads) -> "model"
- attention q-heads -> "model" when divisible; kv projections sharded only
  when n_kv_heads divides the model axis (GQA with kv < axis => replicated)
- batch -> all non-"model" axes ("pod","data")
- ZeRO-1: optimizer state (master/m/v) additionally sharded over "data" on
  the first divisible unsharded dim
- decode KV caches: batch over data axes when divisible; ring length S over
  "model"; recurrent states: width/heads over "model"

Every rule degrades to replication when a dim does not divide the axis.
The rules read only axis names and sizes, so they run on any mesh that
has both (``spmd.Mesh``, a named ``DeviceMesh``, or the reference's
``AbstractMesh`` in the parity tests).  Specs are ``spmd.P`` tuples and
trees are walked with ``torch.utils._pytree`` (dicts and lists; a
non-tensor leaf, the cache's host ``pos``, is a scalar).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.spmd import P, NamedSharding, mesh_shape

PyTree = Any


def _axis(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def named(mesh, spec: P) -> NamedSharding:
    """``spec`` on ``mesh``: ``shard_shape`` gives the per-device shape
    and, on a ``DeviceMesh``, ``placements`` the DTensor placements."""
    return NamedSharding(mesh, spec)


def _key(entry) -> str:
    return getattr(entry, "key", None) or str(getattr(entry, "idx", ""))


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _map_with_path(fn, tree: PyTree) -> PyTree:
    return pytree.tree_map_with_path(
        lambda path, leaf: fn([_key(e) for e in path], _shape(leaf)), tree)


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------
def _leaf_spec(keys: list, shape: tuple, cfg: ModelConfig, mesh) -> P:
    name = keys[-1]
    m = _axis(mesh, "model")
    in_moe_ffn = "ffn" in keys and cfg.moe is not None
    in_rwkv = any("rwkv" in k for k in keys)

    def tail(spec_tail: tuple) -> P:
        """Pad leading stacked-block dims with None."""
        lead = len(shape) - len(spec_tail)
        return P(*([None] * lead + list(spec_tail)))

    def shard_if(dim_size: int, axis="model"):
        return axis if _div(dim_size, _axis(mesh, axis)) else None

    if name == "embed":
        return P(shard_if(shape[0]), None)
    if name == "unembed":
        return P(None, shard_if(shape[1]))
    if name == "frontend_proj":
        return P(None, shard_if(shape[1]))

    if in_moe_ffn and name in ("w1", "w2", "w3"):
        from repro_torch.models import moe as _moe
        if (_moe.MOE_MODE == "ep_decode"
                and cfg.moe.n_experts % m == 0):
            d_ok = _div(shape[-1] if name in ("w1", "w3") else shape[-2],
                        _axis(mesh, "data"))
            fax = "data" if d_ok else None
            if name in ("w1", "w3"):
                return tail(("model", None, fax))
            return tail(("model", fax, None))
        # Expert weights are the bulk of MoE params (>90%): storage is
        # FSDP-sharded over ALL mesh axes on the d_ff dim (model-major, as
        # the reference's spec reads); the compute layout is d_ff over
        # "model" only (DESIGN.md "Pod tooling").
        dpx = data_axes(mesh)
        d = math.prod(_axis(mesh, a) for a in dpx)
        fdim = -1 if name in ("w1", "w3") else -2
        f = shape[fdim]
        if _div(f, m * d) and d > 1:
            ax: Any = ("model",) + dpx
        elif _div(f, m):
            ax = "model"
        else:
            ax = None
        t = [None, None, None]
        t[fdim] = ax
        return tail(tuple(t))
    if name == "router":
        return tail((None, None))

    if name in ("w1", "w3", "cm_w1"):  # [D, F]
        return tail((None, shard_if(shape[-1])))
    if name in ("w2", "cm_w2"):  # [F, D]
        return tail((shard_if(shape[-2]), None))

    if name == "wq":
        ok = _div(cfg.n_heads_c, m)
        return tail((None, "model" if ok else None))
    if name in ("wk", "wv"):
        ok = _div(cfg.n_heads if in_rwkv else cfg.n_kv_heads, m)
        return tail((None, "model" if ok else None))
    if name in ("wr", "wg") and in_rwkv:
        ok = _div(cfg.n_heads, m)
        return tail((None, "model" if ok else None))
    if name == "wo":
        # attn [H*hd, D] / rglru [L, D] / rwkv [H*hd, D]
        return tail((shard_if(shape[-2]), None))
    if name in ("wx", "wg"):  # rglru in-projections [D, L]
        return tail((None, shard_if(shape[-1])))
    if name == "conv":  # [W, L]
        return tail((None, shard_if(shape[-1])))
    if name in ("lambda", "gate_a_w", "gate_a_b", "gate_i_w", "gate_i_b"):
        return tail((shard_if(shape[-1]),))
    if name == "u":  # [H, hd]
        return tail((shard_if(shape[-2]), None))
    if name == "ln_x":  # [H*hd]
        return tail((shard_if(shape[-1]),))
    if name in ("w_lora_a", "w_lora_b"):
        return tail((None, None))
    # norms, mus, biases, small vectors -> replicated
    return P(*([None] * len(shape)))


def param_specs(cfg: ModelConfig, mesh, params_shape: PyTree,
                mode: str = "tp") -> PyTree:
    """Spec tree matching an (abstract) params tree.

    mode="tp": megatron-style TP over "model" + replication.
    mode="fsdp": every weight fully sharded over all axes on its largest
    divisible dim (ZeRO-3); batch is then sharded over all axes too.
    """
    if mode == "fsdp":
        return _map_with_path(lambda keys, shape: _fsdp_leaf_spec(shape, mesh),
                              params_shape)
    return _map_with_path(
        lambda keys, shape: _leaf_spec(keys, shape, cfg, mesh), params_shape)


def _fsdp_leaf_spec(shape: tuple, mesh) -> P:
    axes = tuple(mesh_shape(mesh))
    total = math.prod(_axis(mesh, a) for a in axes)
    parts = [None] * len(shape)
    # largest dim divisible by the full device count gets all axes
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if _div(shape[i], total):
            parts[i] = axes
            return P(*parts)
    # else: one axis on a divisible dim
    for a in axes:
        for i in order:
            if _div(shape[i], _axis(mesh, a)):
                parts[i] = a
                return P(*parts)
    return P(*parts)


def zero1_spec(spec: P, shape: tuple, mesh) -> P:
    """Add data-axes sharding to the first unsharded divisible dim (ZeRO-1),
    over ALL non-model axes ("pod","data")."""
    dpx = data_axes(mesh)
    d = math.prod(_axis(mesh, a) for a in dpx)
    if d == 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p_ in parts:
        if p_ is None:
            continue
        used.update(p_ if isinstance(p_, tuple) else (p_,))
    if used & set(dpx):
        return P(*parts)  # already data-sharded (e.g. FSDP expert weights)
    for i, (p_, s_) in enumerate(zip(parts, shape)):
        if p_ is None and _div(s_, d):
            parts[i] = dpx if len(dpx) > 1 else dpx[0]
            return P(*parts)
    # fall back to "data" only (dim divisible by 16 but not 32)
    dd = _axis(mesh, "data")
    for i, (p_, s_) in enumerate(zip(parts, shape)):
        if p_ is None and _div(s_, dd):
            parts[i] = "data"
            return P(*parts)
    return P(*parts)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def train_state_specs(cfg: ModelConfig, mesh, state_shape: PyTree) -> PyTree:
    """Specs for {"params","master","m","v","step"}."""
    p_specs = param_specs(cfg, mesh, state_shape["params"])

    def z(tree_shape):
        return pytree.tree_map(
            lambda spec, leaf: zero1_spec(spec, _shape(leaf), mesh),
            p_specs, tree_shape, is_leaf=_is_spec)

    return {
        "params": p_specs,
        "master": z(state_shape["master"]),
        "m": z(state_shape["m"]),
        "v": z(state_shape["v"]),
        "step": P(),
    }


# --------------------------------------------------------------------------
# Batch / cache specs
# --------------------------------------------------------------------------
def _dp(mesh) -> tuple:
    dp = data_axes(mesh)
    return dp, math.prod(_axis(mesh, a) for a in dp)


def batch_specs(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh,
                batch_shape: PyTree) -> PyTree:
    dp, dp_size = _dp(mesh)

    def spec_for(keys, shp):
        lead = dp if _div(shp[0], dp_size) else None
        return P(lead, *([None] * (len(shp) - 1)))

    return _map_with_path(spec_for, batch_shape)


def cache_specs(cfg: ModelConfig, mesh, cache_shape: PyTree) -> PyTree:
    """Decode/prefill cache specs.  Layout per leaf (``init_cache``):
    k/v: [n_blocks?, B, S, KV, hd]; rglru h: [n?, B, L], conv: [n?, B, W-1,
    L]; rwkv s: [n?, B, H, hd, hd], xtm/xcm: [n?, B, D]; enc k/v: [n, B, Te,
    KV, hd]; pos: scalar."""
    dp, dp_size = _dp(mesh)
    m = _axis(mesh, "model")

    def spec_for(keys, shp):
        name = next((k for k in reversed(keys) if not k.isdigit()), "")
        if name == "pos" or len(shp) == 0:
            return P()
        stacked = any(k in ("blocks", "enc") for k in keys)
        i0 = 1 if stacked else 0  # index of B dim

        def dshard(sz):
            return dp if _div(sz, dp_size) else None

        parts = [None] * len(shp)
        if name in ("k", "v"):
            B, S = shp[i0], shp[i0 + 1]
            parts[i0] = dshard(B)
            if parts[i0] is None and _div(B, _axis(mesh, "data")):
                parts[i0] = ("data",)
            parts[i0 + 1] = "model" if _div(S, m) else None
            return P(*parts)
        if name in ("h", "s"):
            parts[i0] = dshard(shp[i0])
            parts[i0 + 1] = "model" if _div(shp[i0 + 1], m) else None
            return P(*parts)
        if name == "conv":
            parts[i0] = dshard(shp[i0])
            parts[i0 + 2] = "model" if _div(shp[i0 + 2], m) else None
            return P(*parts)
        if name in ("xtm", "xcm"):
            parts[i0] = dshard(shp[i0])
        return P(*parts)

    return _map_with_path(spec_for, cache_shape)
