"""Decoder stack: block init/apply for the layer kinds the port serves, with
decode caches: the port of the reference's ``repro/models/transformer.py``.

Layer kinds: "attn" | "attn_swa" | "attn_local" | "rglru" | "rwkv".  The
stack is grouped into repeating pattern blocks (``cfg.block_pattern``), and
each slot's parameters are stacked on a leading block axis, as in the
reference; where the reference scans that axis with ``lax.scan``, the port
loops over it in Python.  The reference's ``mesh``, ``remat`` and
``unroll`` options are not carried over.  MoE FFNs, the encoder-decoder
stack and the modality frontends come with later slices of the port and
raise ``NotImplementedError``.

``decode_step`` updates the cache in place and returns it (the reference's
serving loop donates the cache to the same effect).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv as RW

PyTree = Any
ATTN_KINDS = ("attn", "attn_swa", "attn_local")


# ==========================================================================
# Structure helpers
# ==========================================================================
def stack_structure(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...],
                                               Tuple[str, ...]]:
    """(n_full_blocks, pattern, tail_kinds)."""
    pat = cfg.block_pattern
    n_full = cfg.n_layers // len(pat)
    tail = cfg.layer_kinds[n_full * len(pat):]
    return n_full, pat, tail


def slot_name(i: int, kind: str) -> str:
    return f"b{i}_{kind}"


def check_supported(cfg: ModelConfig):
    """Raise for the parts of the reference's stack not ported yet."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs (models/moe.py) come with a later slice "
            f"of the port")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder stack comes with a later slice "
            f"of the port")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend comes with a later "
            f"slice of the port")


def _index(tree: PyTree, i: int) -> PyTree:
    """Block ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _store(stacked: dict, i: int, tree: dict):
    """Write ``tree`` into block ``i`` of ``stacked`` in place (leaves that
    already are that block's storage are left alone)."""
    for k, v in tree.items():
        dst = stacked[k][i]
        if dst.data_ptr() != v.data_ptr():
            dst.copy_(v)


# ==========================================================================
# Param init
# ==========================================================================
class _Init:
    """The reference's initialisation laws, drawn on ``device`` from one
    seeded generator.  With ``n``, every tensor is drawn as one stacked
    ``[n, ...]`` tensor: full width never holds a per-block list."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std, n=None, dtype=None):
        lead = () if n is None else (n,)
        return torch.empty(lead + tuple(shape), dtype=dtype or self.dtype,
                           device=self.device).normal_(0.0, std,
                                                       generator=self.g)

    def zeros(self, shape, n=None, dtype=torch.float32):
        lead = () if n is None else (n,)
        return torch.zeros(lead + tuple(shape), dtype=dtype,
                           device=self.device)

    def ffn(self, cfg: ModelConfig, n=None) -> dict:
        s_in, s_out = 1.0 / math.sqrt(cfg.d_model), 1.0 / math.sqrt(cfg.d_ff)
        return {"w1": self.normal((cfg.d_model, cfg.d_ff), s_in, n),
                "w3": self.normal((cfg.d_model, cfg.d_ff), s_in, n),
                "w2": self.normal((cfg.d_ff, cfg.d_model), s_out, n)}

    def attn(self, cfg: ModelConfig, n=None) -> dict:
        # hc >= n_heads: padded compute heads carry zero weights (inert)
        d, h, hc, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_heads_c,
                            cfg.n_kv_heads, cfg.head_dim_)
        wq = self.zeros((d, hc * hd), n, self.dtype)
        wq[..., :h * hd].normal_(0.0, 1.0 / math.sqrt(d), generator=self.g)
        wo = self.zeros((hc * hd, d), n, self.dtype)
        wo[..., :h * hd, :].normal_(0.0, 1.0 / math.sqrt(h * hd),
                                    generator=self.g)
        p = {"wq": wq,
             "wk": self.normal((d, kv * hd), 1.0 / math.sqrt(d), n),
             "wv": self.normal((d, kv * hd), 1.0 / math.sqrt(d), n),
             "wo": wo}
        if cfg.qk_norm:
            p["q_norm"] = self.zeros((hd,), n)
            p["k_norm"] = self.zeros((hd,), n)
        return p

    def block(self, cfg: ModelConfig, kind: str, n=None) -> dict:
        p: dict = {"norm1": self.zeros((cfg.d_model,), n)}
        if kind in ATTN_KINDS:
            p.update(self.attn(cfg, n))
        elif kind == "rglru":
            p.update(RG.init_rglru_params(
                cfg.d_model, cfg.rglru_conv_width, generator=self.g,
                device=self.device, dtype=self.dtype, n=n))
        elif kind == "rwkv":
            p.update(RW.init_rwkv_params(
                cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.rwkv_head_dim,
                generator=self.g, device=self.device, dtype=self.dtype, n=n))
            p["norm2"] = self.zeros((cfg.d_model,), n)
            return p  # rwkv carries its own channel-mix; no separate ffn
        else:
            raise ValueError(kind)
        p["norm2"] = self.zeros((cfg.d_model,), n)
        p["ffn"] = self.ffn(cfg, n)
        return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator, device,
                dtype=torch.float32) -> PyTree:
    """The parameter tree of the reference's ``init_params``: ``embed``,
    ``final_norm``, ``unembed`` (unless tied), ``blocks[slot][name]``
    stacked on a leading block axis, and the ``tail`` list.  The draws
    follow the reference's laws but are ``generator``'s, not
    ``jax.random``'s."""
    check_supported(cfg)
    n_full, pat, tail = stack_structure(cfg)
    init = _Init(generator, device, dtype)
    V, D = cfg.padded_vocab, cfg.d_model
    params: dict = {"embed": init.normal((V, D), 0.02),
                    "final_norm": init.zeros((D,))}
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((D, V), 0.02)
    params["blocks"] = ({slot_name(i, kind): init.block(cfg, kind, n_full)
                         for i, kind in enumerate(pat)} if n_full else {})
    if tail:
        params["tail"] = [init.block(cfg, kind) for kind in tail]
    return params


# ==========================================================================
# Block apply — full sequence (prefill)
# ==========================================================================
def _attn_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "attn_swa":
        return cfg.sliding_window
    if kind == "attn_local":
        return cfg.attn_local_window
    return None


def _proj_qkv(h, p, cfg: ModelConfig, positions, rope: bool = True):
    B, T, D = h.shape
    H, KV, hd = cfg.n_heads_c, cfg.n_kv_heads, cfg.head_dim_
    q = (h @ p["wq"]).reshape(B, T, H, hd)
    k = (h @ p["wk"]).reshape(B, T, KV, hd)
    v = (h @ p["wv"]).reshape(B, T, KV, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,T,KV,hd] -> [B,T,H,hd], each kv head repeated H/KV times in place
    (``jnp.repeat``, not tiling)."""
    KV = t.shape[2]
    if KV == n_heads:
        return t
    return torch.repeat_interleave(t, n_heads // KV, dim=2)


def _seq_to_ring_cache(k, v, S: int) -> dict:
    """Store the last S tokens of k/v at ring slots (t mod S)."""
    B, T, KV, hd = k.shape
    if T <= S:  # slots are t mod S == t for t < T: already aligned
        return {"k": F.pad(k, (0, 0, 0, 0, 0, S - T)),
                "v": F.pad(v, (0, 0, 0, 0, 0, S - T))}
    slots = torch.remainder(torch.arange(T - S, T, device=k.device), S)
    kc = torch.zeros((B, S, KV, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros((B, S, KV, hd), dtype=v.dtype, device=v.device)
    kc[:, slots] = k[:, T - S:]
    vc[:, slots] = v[:, T - S:]
    return {"k": kc, "v": vc}


def attn_block_seq(x, p, cfg: ModelConfig, kind: str, positions,
                   want_cache=False, q_chunk=1024):
    """Returns (x, cache_or_None)."""
    window = _attn_window(cfg, kind)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg, positions)
    o = L.attention(q, _expand_kv(k, cfg.n_heads_c),
                    _expand_kv(v, cfg.n_heads_c), causal=True, window=window,
                    q_positions=positions, k_positions=positions,
                    q_chunk=q_chunk)
    B, T, H, hd = o.shape
    x = x + o.reshape(B, T, H * hd) @ p["wo"]
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + L.swiglu(h2, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    cache = None
    if want_cache:
        # a windowed ring holds min(window, T) slots: only as long as the
        # prompt, as in the reference
        S = min(window, T) if window else T
        cache = _seq_to_ring_cache(k, v, S)
    return x, cache


def rglru_block_seq(x, p, cfg: ModelConfig, want_cache=False, h0=None,
                    conv_state=None):
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, h_last, conv_state = RG.rglru_apply(h, p, h0=h0,
                                           conv_state=conv_state)
    x = x + y
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + L.swiglu(h2, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    cache = {"h": h_last, "conv": conv_state} if want_cache else None
    return x, cache


def rwkv_block_seq(x, p, cfg: ModelConfig, want_cache=False, state=None):
    """state: None or dict(s, xtm, xcm)."""
    s0 = state["s"] if state else None
    xtm = state["xtm"] if state else None
    xcm = state["xcm"] if state else None
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, (x_last_tm, s_last) = RW.rwkv_time_mix(
        h, p, cfg.n_heads, cfg.rwkv_head_dim, x_prev=xtm, s0=s0)
    x = x + y.to(x.dtype)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    y2, x_last_cm = RW.rwkv_channel_mix(h2, p, x_prev=xcm)
    x = x + y2.to(x.dtype)
    cache = ({"s": s_last, "xtm": x_last_tm.to(x.dtype),
              "xcm": x_last_cm.to(x.dtype)} if want_cache else None)
    return x, cache


def apply_block_seq(x, p, cfg, kind, positions, want_cache=False,
                    cache_in=None, q_chunk=1024):
    if kind in ATTN_KINDS:
        return attn_block_seq(x, p, cfg, kind, positions,
                              want_cache=want_cache, q_chunk=q_chunk)
    if kind == "rglru":
        st = cache_in or {}
        return rglru_block_seq(x, p, cfg, want_cache=want_cache,
                               h0=st.get("h"), conv_state=st.get("conv"))
    if kind == "rwkv":
        return rwkv_block_seq(x, p, cfg, want_cache=want_cache,
                              state=cache_in)
    raise ValueError(kind)


# ==========================================================================
# Block apply — decode (single token, ring caches)
# ==========================================================================
def attn_block_decode(x, p, cache, cfg: ModelConfig, kind: str, pos: int):
    """x: [B,1,D]; cache: {"k","v"} ring [B,S,KV,hd], written in place;
    pos: tokens generated so far (the current token's absolute
    position)."""
    window = _attn_window(cfg, kind)
    B = x.shape[0]
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _proj_qkv(h, p, cfg, positions)
    kc, vc = cache["k"], cache["v"]
    slot = pos % kc.shape[1]
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    o = L.decode_attention(q, _expand_kv(kc, cfg.n_heads_c),
                           _expand_kv(vc, cfg.n_heads_c), pos + 1,
                           window=window)
    _, _, H, hd = o.shape
    x = x + o.reshape(B, 1, H * hd) @ p["wo"]
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    y = L.swiglu(h2, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    return x + y, {"k": kc, "v": vc}


def apply_block_decode(x, p, cache, cfg, kind, pos: int):
    if kind in ATTN_KINDS:
        return attn_block_decode(x, p, cache, cfg, kind, pos)
    if kind == "rglru":
        return rglru_block_seq(x, p, cfg, want_cache=True, h0=cache["h"],
                               conv_state=cache["conv"])
    if kind == "rwkv":
        return rwkv_block_seq(x, p, cfg, want_cache=True, state=cache)
    raise ValueError(kind)


# ==========================================================================
# Cache init
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device,
               dtype=torch.float32) -> PyTree:
    """Zero decode caches for the whole stack.  seq_len = max context
    length (ring size is min(seq_len, window) for windowed kinds)."""
    check_supported(cfg)
    n_full, pat, tail = stack_structure(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim_

    def one(kind, n=None):
        lead = () if n is None else (n,)

        def z(*shape, dt=dtype):
            return torch.zeros(lead + shape, dtype=dt, device=device)

        if kind in ATTN_KINDS:
            w = _attn_window(cfg, kind)
            S = min(seq_len, w) if w is not None else seq_len
            return {"k": z(batch, S, KV, hd), "v": z(batch, S, KV, hd)}
        if kind == "rglru":
            return {"h": z(batch, cfg.d_model, dt=torch.float32),
                    "conv": z(batch, cfg.rglru_conv_width - 1, cfg.d_model)}
        if kind == "rwkv":
            hd_r = cfg.rwkv_head_dim
            return {"s": z(batch, cfg.n_heads, hd_r, hd_r, dt=torch.float32),
                    "xtm": z(batch, cfg.d_model),
                    "xcm": z(batch, cfg.d_model)}
        raise ValueError(kind)

    cache: dict = {"pos": 0, "blocks": {}}
    if n_full:
        cache["blocks"] = {slot_name(i, kind): one(kind, n_full)
                           for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [one(kind) for kind in tail]
    return cache


# ==========================================================================
# Full-stack apply
# ==========================================================================
def _readout(params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].T
    return x @ unembed


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            want_cache: bool = False, q_chunk: int = 1024,
            last_only: bool = False):
    """Full-sequence forward.  tokens: [B, T] integer.  Returns (logits
    [B,T,V] (or [B,1,V] with ``last_only``), cache or None).  The cache's
    ``pos`` is a host int."""
    check_supported(cfg)
    n_full, pat, tail = stack_structure(cfg)
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(T, device=x.device).expand(B, T)
    block_caches = {slot_name(i, kind): [] for i, kind in enumerate(pat)}
    for bi in range(n_full):
        for i, kind in enumerate(pat):
            sn = slot_name(i, kind)
            x, c = apply_block_seq(x, _index(params["blocks"][sn], bi), cfg,
                                   kind, positions, want_cache=want_cache,
                                   q_chunk=q_chunk)
            if want_cache:
                block_caches[sn].append(c)
    caches: dict = {"pos": T, "blocks": {}}
    if want_cache and n_full:
        caches["blocks"] = {sn: _stack(cs) for sn, cs in block_caches.items()}
    for i, kind in enumerate(tail):
        x, c = apply_block_seq(x, params["tail"][i], cfg, kind, positions,
                               want_cache=want_cache, q_chunk=q_chunk)
        if want_cache:
            caches.setdefault("tail", []).append(c)
    if last_only:  # prefill: only the last position's logits are needed
        x = x[:, -1:, :]
    return _readout(params, x, cfg), (caches if want_cache else None)


def decode_step(params, cache, token: torch.Tensor, cfg: ModelConfig):
    """One decode step.  token: [B,1] integer.  Returns (logits [B,1,V],
    cache): the cache is updated in place and returned."""
    n_full, pat, tail = stack_structure(cfg)
    pos = cache["pos"]
    x = params["embed"][token.long()]
    for bi in range(n_full):
        for i, kind in enumerate(pat):
            sn = slot_name(i, kind)
            stacked = cache["blocks"][sn]
            x, c = apply_block_decode(x, _index(params["blocks"][sn], bi),
                                      _index(stacked, bi), cfg, kind, pos)
            _store(stacked, bi, c)
    for i, kind in enumerate(tail):
        x, cache["tail"][i] = apply_block_decode(
            x, params["tail"][i], cache["tail"][i], cfg, kind, pos)
    cache["pos"] = pos + 1
    return _readout(params, x, cfg), cache
