"""Decoder stack: block init/apply for every layer kind, with decode caches
and the encoder-decoder (whisper) stack: the port of the reference's
``repro/models/transformer.py``.

Layer kinds: "attn" | "attn_swa" | "attn_local" | "rglru" | "rwkv".  The
stack is grouped into repeating pattern blocks (``cfg.block_pattern``), and
each slot's parameters are stacked on a leading block axis, as in the
reference; where the reference scans that axis with ``lax.scan``, the port
loops over it in Python (``unroll`` has nothing left to choose).  MoE FFNs
run under ``models/moe.py``'s ``moe_ffn``: ``mesh`` (a
``sharding.spmd.Mesh`` or a named ``DeviceMesh``) reaches it through
``forward``/``decode_step``, and decode's ``_kv_seq_spec`` constraint is a
layout hint (a no-op on the single-process binding, a ``redistribute`` of
a DTensor cache).  ``forward``'s ``remat`` is the reference's activation
checkpointing, through ``torch.utils.checkpoint``; its ``chunked`` sends
the recurrences down their differentiable training route instead of the
B4/B5 kernels.

The modality frontends are the reference's stubs: precomputed embeddings
through one ``frontend_proj`` matmul, prepended to the text (vision) or
fed to the encoder (audio).  The encoder is a stack of non-causal ``attn``
blocks; every decoder attention block then cross-attends to its output
(``normx``, ``xattn``: no RoPE, no qk norms), and decode reads the
cross K/V precomputed at prefill (``cache["enc"]``).

The reference's ``_grad_transparent_barrier`` (an XLA scheduling barrier
that differentiates as identity) has no counterpart: eager PyTorch has no
schedule to fence.

``decode_step`` updates the cache in place and returns it (the reference's
serving loop donates the cache to the same effect).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv as RW
from repro_torch.sharding.rules import data_axes, named
from repro_torch.sharding.spmd import (P, hold_layout, lookup_rows,
                                       mesh_shape, with_sharding_constraint)

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


def _index(tree: PyTree, i: int) -> PyTree:
    """Block ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree: PyTree, n: int) -> list:
    """The ``n`` blocks of a stacked tree, as views.  Unbinding once (not
    indexing per block) gives each leaf one backward node that stacks the
    blocks' gradients."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _store(stacked: dict, i: int, tree: dict):
    """Write ``tree`` into block ``i`` of ``stacked`` in place (leaves that
    already are that block's storage are left alone)."""
    for k, v in tree.items():
        dst = stacked[k][i]
        if not _same_memory(dst, v):
            dst.copy_(v)


def _same_memory(a, b) -> bool:
    """Whether ``a`` and ``b`` view the same memory (for DTensors, whether
    their local shards do): a storage and an offset, which ``meta``
    tensors have too (their ``data_ptr`` is 0)."""
    if isinstance(a, DTensor):
        a, b = a.to_local(), b.to_local()
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


# ==========================================================================
# Param init
# ==========================================================================
class _Init:
    """The reference's initialisation laws, drawn on ``device`` from one
    seeded generator.  With ``n``, every tensor is drawn as one stacked
    ``[n, ...]`` tensor: full width never holds a per-block list."""

    def __init__(self, generator: Optional[torch.Generator], device, dtype):
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
        if cfg.moe is not None:
            return MOE.init_moe_params(cfg.d_model, cfg.d_ff, cfg.moe,
                                       generator=self.g, device=self.device,
                                       dtype=self.dtype, n=n)
        s_in, s_out = 1.0 / math.sqrt(cfg.d_model), 1.0 / math.sqrt(cfg.d_ff)
        return {"w1": self.normal((cfg.d_model, cfg.d_ff), s_in, n),
                "w3": self.normal((cfg.d_model, cfg.d_ff), s_in, n),
                "w2": self.normal((cfg.d_ff, cfg.d_model), s_out, n)}

    def attn(self, cfg: ModelConfig, n=None, cross: bool = False) -> dict:
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
        if cfg.qk_norm and not cross:
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

    def cross_extra(self, cfg: ModelConfig, n=None) -> dict:
        return {"normx": self.zeros((cfg.d_model,), n),
                "xattn": self.attn(cfg, n, cross=True)}


def init_ffn(cfg: ModelConfig, *, generator: Optional[torch.Generator],
             device, dtype=torch.float32, n: Optional[int] = None) -> dict:
    """A block's FFN: dense SwiGLU, or the MoE's router and experts."""
    return _Init(generator, device, dtype).ffn(cfg, n)


def init_attn(cfg: ModelConfig, *, generator: Optional[torch.Generator],
              device, dtype=torch.float32, cross: bool = False,
              n: Optional[int] = None) -> dict:
    """An attention sublayer (``cross``: no qk norms)."""
    return _Init(generator, device, dtype).attn(cfg, n, cross=cross)


def init_block(cfg: ModelConfig, kind: str, *,
               generator: Optional[torch.Generator], device,
               dtype=torch.float32, n: Optional[int] = None) -> dict:
    """One block of ``kind`` (with ``n``, ``n`` blocks stacked)."""
    return _Init(generator, device, dtype).block(cfg, kind, n)


def init_cross_block_extra(cfg: ModelConfig, *,
                           generator: Optional[torch.Generator], device,
                           dtype=torch.float32,
                           n: Optional[int] = None) -> dict:
    """The cross-attention sublayer added to a decoder block of an
    encoder-decoder model: ``normx`` and ``xattn`` (no qk norms)."""
    return _Init(generator, device, dtype).cross_extra(cfg, n)


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator],
                device, dtype=torch.float32) -> PyTree:
    """The parameter tree of the reference's ``init_params``: ``embed``,
    ``final_norm``, ``unembed`` (unless tied), ``frontend_proj`` (with a
    frontend), ``blocks[slot][name]`` stacked on a leading block axis (an
    encoder-decoder's attention slots with ``normx``/``xattn``), the
    ``tail`` list, and ``encoder`` (stacked ``attn`` blocks) with
    ``enc_norm``.  The draws follow the reference's laws but are
    ``generator``'s, not ``jax.random``'s."""
    n_full, pat, tail = stack_structure(cfg)
    init = _Init(generator, device, dtype)
    V, D = cfg.padded_vocab, cfg.d_model
    params: dict = {"embed": init.normal((V, D), 0.02),
                    "final_norm": init.zeros((D,))}
    if not cfg.tie_embeddings:
        params["unembed"] = init.normal((D, V), 0.02)
    if cfg.frontend is not None:
        params["frontend_proj"] = init.normal((D, D), 1.0 / math.sqrt(D))
    blocks = {}
    for i, kind in enumerate(pat if n_full else ()):
        blocks[slot_name(i, kind)] = init.block(cfg, kind, n_full)
        if cfg.is_encdec and kind in ATTN_KINDS:
            blocks[slot_name(i, kind)].update(init.cross_extra(cfg, n_full))
    params["blocks"] = blocks
    if tail:
        params["tail"] = [init.block(cfg, kind) for kind in tail]
    if cfg.is_encdec:
        params["encoder"] = init.block(cfg, "attn", cfg.encoder_layers)
        params["enc_norm"] = init.zeros((D,))
    return params


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16) -> PyTree:
    """The tree of ``init_params`` on the ``meta`` device: shapes and
    dtypes without allocating (the counterpart of ``jax.eval_shape``)."""
    return init_params(cfg, generator=None, device="meta", dtype=dtype)


# ==========================================================================
# Block apply — full sequence (train / prefill)
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
    if T == S:  # slot t holds token t: the keys and values themselves
        return {"k": k, "v": v}
    if T < S:  # slots are t mod S == t for t < T: already aligned
        return {"k": F.pad(k, (0, 0, 0, 0, 0, S - T)),
                "v": F.pad(v, (0, 0, 0, 0, 0, S - T))}
    # tokens T-S..T-1 fill every slot once: the last S tokens rotated by
    # T mod S (a rotation, not an indexed write, which DTensor cannot do)
    r = T % S

    def ring(t):
        tail = t[:, T - S:]
        return torch.cat([tail[:, S - r:], tail[:, :S - r]], dim=1)

    return {"k": ring(k), "v": ring(v)}


def cfg_cache_len(cfg: ModelConfig, kind: str) -> int:
    w = _attn_window(cfg, kind)
    return w if w is not None else 0


def make_cache_len(cfg: ModelConfig, kind: str, seq_len: int) -> int:
    w = _attn_window(cfg, kind)
    return min(seq_len, w) if w is not None else seq_len


def _act(x, mesh=None):
    """A sublayer's output [B,T,D] constrained to the residual stream's
    layout: batch over the data axes where it divides, the rest
    replicated (the reference's megatron layout, where a row-parallel
    product's partial sums are all-reduced).  DTensor alone would often
    reduce-scatter them over T instead and gather the next weight; and a
    vocab-sharded embedding's partial sums can be reduced only while
    DTensor holds their mask, so they are reduced here.  A plain tensor,
    and any tensor without a mesh, is returned as it is."""
    if mesh is None:
        return x
    dp = data_axes(mesh)
    dsz = math.prod(mesh_shape(mesh)[a] for a in dp)
    bspec = dp if x.shape[0] % max(dsz, 1) == 0 else None
    return with_sharding_constraint(
        x, named(mesh, P(bspec, *([None] * (x.dim() - 1)))))


def _embed(params, tokens, mesh=None):
    """``F.embedding``, not indexing: its backward on the card sums a
    token's rows in a fixed order (indexing's backward accumulates with
    atomics).  A DTensor table sharded over its vocab is looked up shard
    by shard (``lookup_rows``)."""
    x = lookup_rows(params["embed"], tokens,
                    lambda t, i: F.embedding(i, t), 0)
    if x is None:
        x = F.embedding(tokens.long(), params["embed"])
    return _act(x, mesh)


def _ffn(h2, p, cfg: ModelConfig, mesh=None):
    """(y, aux): the MoE's load-balance loss, or 0."""
    if cfg.moe is not None:
        return MOE.moe_ffn(h2, p["ffn"], cfg.moe, mesh)
    y = L.swiglu(h2, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])
    return _act(y, mesh), _zero(h2)


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _cross_kv(enc_out, px, cfg: ModelConfig):
    """The cross-attention keys and values of ``enc_out`` [B,Te,D]."""
    B, Te, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    return ((enc_out @ px["wk"]).reshape(B, Te, KV, hd),
            (enc_out @ px["wv"]).reshape(B, Te, KV, hd))


def _cross_attend(x, p, cfg: ModelConfig, k, v, q_chunk, mesh=None):
    """The cross-attention sublayer: queries from the decoder stream ``x``
    [B,T,D], keys/values [B,Te,KV,hd] from the encoder's output; no RoPE,
    no mask."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads_c, cfg.head_dim_
    px = p["xattn"]
    q = (L.rms_norm(x, p["normx"], cfg.norm_eps) @ px["wq"]).reshape(
        B, T, H, hd)
    o = L.attention(q, _expand_kv(k, H), _expand_kv(v, H), causal=False,
                    q_chunk=q_chunk)
    return x + _act(hold_layout(o.reshape(B, T, H * hd)) @ px["wo"], mesh)


def attn_block_seq(x, p, cfg: ModelConfig, kind: str, positions,
                   mesh=None, want_cache=False, causal=True, enc_out=None,
                   q_chunk=1024):
    """Returns (x, cache_or_None, aux_loss).  ``causal=False``: the
    encoder's blocks; ``enc_out`` [B,Te,D]: a decoder block of an
    encoder-decoder model cross-attends to it."""
    window = _attn_window(cfg, kind)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg, positions)
    o = L.attention(q, _expand_kv(k, cfg.n_heads_c),
                    _expand_kv(v, cfg.n_heads_c), causal=causal,
                    window=window, q_positions=positions,
                    k_positions=positions, q_chunk=q_chunk)
    B, T, H, hd = o.shape
    x = x + _act(hold_layout(o.reshape(B, T, H * hd)) @ p["wo"], mesh)
    if enc_out is not None:
        x = _cross_attend(x, p, cfg, *_cross_kv(enc_out, p["xattn"], cfg),
                          q_chunk, mesh)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _ffn(h2, p, cfg, mesh)
    x = x + y
    cache = None
    if want_cache:
        # a windowed ring holds min(window, T) slots: only as long as the
        # prompt, as in the reference
        S = min(window, T) if window else T
        cache = _seq_to_ring_cache(k, v, S)
    return x, cache, aux


def rglru_block_seq(x, p, cfg: ModelConfig, want_cache=False, h0=None,
                    conv_state=None, chunked=False, mesh=None):
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, h_last, conv_state = RG.rglru_apply(h, p, h0=h0,
                                           conv_state=conv_state,
                                           chunked=chunked)
    x = x + _act(y, mesh)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + _act(L.swiglu(h2, p["ffn"]["w1"], p["ffn"]["w3"],
                          p["ffn"]["w2"]), mesh)
    cache = {"h": h_last, "conv": conv_state} if want_cache else None
    return x, cache, _zero(x)


def rwkv_block_seq(x, p, cfg: ModelConfig, want_cache=False, state=None,
                   chunked=False, mesh=None):
    """state: None or dict(s, xtm, xcm)."""
    s0 = state["s"] if state else None
    xtm = state["xtm"] if state else None
    xcm = state["xcm"] if state else None
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, (x_last_tm, s_last) = RW.rwkv_time_mix(
        h, p, cfg.n_heads, cfg.rwkv_head_dim, x_prev=xtm, s0=s0,
        chunked=chunked)
    x = x + _act(y.to(x.dtype), mesh)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    y2, x_last_cm = RW.rwkv_channel_mix(h2, p, x_prev=xcm)
    x = x + _act(y2.to(x.dtype), mesh)
    cache = ({"s": s_last, "xtm": x_last_tm.to(x.dtype),
              "xcm": x_last_cm.to(x.dtype)} if want_cache else None)
    return x, cache, _zero(x)


def apply_block_seq(x, p, cfg, kind, positions, mesh=None, want_cache=False,
                    cache_in=None, enc_out=None, q_chunk=1024, chunked=False):
    """Returns (x, cache_or_None, aux_loss).  ``chunked``: the recurrences'
    differentiable training route (``rwkv.py``, ``rglru.py``)."""
    if kind in ATTN_KINDS:
        return attn_block_seq(x, p, cfg, kind, positions, mesh=mesh,
                              want_cache=want_cache, enc_out=enc_out,
                              q_chunk=q_chunk)
    if kind == "rglru":
        st = cache_in or {}
        return rglru_block_seq(x, p, cfg, want_cache=want_cache,
                               h0=st.get("h"), conv_state=st.get("conv"),
                               chunked=chunked, mesh=mesh)
    if kind == "rwkv":
        return rwkv_block_seq(x, p, cfg, want_cache=want_cache,
                              state=cache_in, chunked=chunked, mesh=mesh)
    raise ValueError(kind)


# ==========================================================================
# Block apply — decode (single token, ring caches)
# ==========================================================================
def _kv_seq_spec(mesh, B: int, S: int):
    """Flash-decoding layout for [B,S,H,hd]: batch over data axes, ring
    length over "model"."""
    dp = data_axes(mesh)
    dsz = math.prod(mesh_shape(mesh)[a] for a in dp)
    bspec = dp if B % max(dsz, 1) == 0 else None
    sspec = "model" if S % mesh_shape(mesh)["model"] == 0 else None
    return named(mesh, P(bspec, sspec, None, None))


def _ring_write(ring, new, pos: int):
    """Write the token ``new`` [B,1,KV,hd] into slot ``pos mod S`` of the
    ring [B,S,KV,hd], in place.  A DTensor ring sharded over S cannot be
    indexed in place, so it is rewritten through a select of the slot,
    as SPMD partitioners lower a dynamic update of a sharded dim."""
    S = ring.shape[1]
    if not isinstance(ring, DTensor):
        ring[:, pos % S] = new[:, 0].to(ring.dtype)
        return
    hit = torch.arange(S, device=new.device) == pos % S
    ring.copy_(torch.where(hit[None, :, None, None], new.to(ring.dtype),
                           ring))


def attn_block_decode(x, p, cache, cfg: ModelConfig, kind: str, pos: int,
                      mesh=None, enc_cache=None):
    """x: [B,1,D]; cache: {"k","v"} ring [B,S,KV,hd], written in place;
    pos: tokens generated so far (the current token's absolute position);
    enc_cache: this block's cross-attention {"k","v"} [B,Te,KV,hd], every
    key attended."""
    window = _attn_window(cfg, kind)
    B = x.shape[0]
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _proj_qkv(h, p, cfg, positions)
    kc, vc = cache["k"], cache["v"]
    _ring_write(kc, k, pos)
    _ring_write(vc, v, pos)
    kx = _expand_kv(kc, cfg.n_heads_c)
    vx = _expand_kv(vc, cfg.n_heads_c)
    if mesh is not None and "model" in mesh_shape(mesh):
        sh = _kv_seq_spec(mesh, kx.shape[0], kc.shape[1])
        kx = with_sharding_constraint(kx, sh)
        vx = with_sharding_constraint(vx, sh)
    o = L.decode_attention(q, kx, vx, pos + 1, window=window)
    _, _, H, hd = o.shape
    x = x + _act(o.reshape(B, 1, H * hd) @ p["wo"], mesh)
    if enc_cache is not None:
        x = _cross_attend(x, p, cfg, enc_cache["k"], enc_cache["v"], 1,
                          mesh)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    y, _ = _ffn(h2, p, cfg, mesh)
    return x + y, {"k": kc, "v": vc}


def apply_block_decode(x, p, cache, cfg, kind, pos: int, mesh=None,
                       enc_cache=None):
    if kind in ATTN_KINDS:
        return attn_block_decode(x, p, cache, cfg, kind, pos, mesh=mesh,
                                 enc_cache=enc_cache)
    if kind == "rglru":
        x, st, _ = rglru_block_seq(x, p, cfg, want_cache=True,
                                   h0=cache["h"], conv_state=cache["conv"],
                                   mesh=mesh)
        return x, st
    if kind == "rwkv":
        x, st, _ = rwkv_block_seq(x, p, cfg, want_cache=True, state=cache,
                                  mesh=mesh)
        return x, st
    raise ValueError(kind)


# ==========================================================================
# Cache init
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device,
               dtype=torch.float32) -> PyTree:
    """Zero decode caches for the whole stack.  seq_len = max context
    length (ring size is min(seq_len, window) for windowed kinds).  An
    encoder-decoder's ``enc`` holds the cross K/V, [encoder_layers, batch,
    encoder_seq, KV, hd], stacked over the encoder's layers as in the
    reference (whose prefill stacks them over the decoder's blocks)."""
    n_full, pat, tail = stack_structure(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim_

    def one(kind, n=None):
        lead = () if n is None else (n,)

        def z(*shape, dt=dtype):
            return torch.zeros(lead + shape, dtype=dt, device=device)

        if kind in ATTN_KINDS:
            S = make_cache_len(cfg, kind, seq_len)
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
    if cfg.is_encdec:
        shape = (cfg.encoder_layers, batch, cfg.encoder_seq, KV, hd)
        cache["enc"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
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


def _remat_policy(ctx, op, *args, **kwargs):
    """"dots": keep the matrix products without batch dims (the
    reference's ``dots_with_no_batch_dims_saveable``), recompute the
    rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the reference's activation-checkpointing ``policy``:
    "none"; "full" and "2level" (recompute the block in the backward);
    "dots" (save only the matmul outputs)."""
    if policy == "none":
        return fn
    if policy in ("full", "2level"):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _remat_policy))
    raise ValueError(policy)


def _group_factor(n: int) -> int:
    """Divisor of n closest to sqrt(n) (for 2-level remat grouping)."""
    best, target = 1, math.sqrt(n)
    for g in range(1, n + 1):
        if n % g == 0 and abs(g - target) < abs(best - target):
            best = g
    return best


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, mesh=None,
            frontend_embeds: Optional[torch.Tensor] = None,
            want_cache: bool = False, remat: str = "none",
            q_chunk: int = 1024, last_only: bool = False,
            chunked: bool = False):
    """Full-sequence forward.  tokens: [B, T_text] integer;
    ``frontend_embeds``: [B, Nf, D] patch embeddings (vision: projected
    and prepended, so T = Nf + T_text) or [B, Te, D] frames (audio: the
    encoder's input; without them the decoder skips its cross-attention,
    as the reference's does).  Returns (logits [B,T,V] (or [B,1,V] with
    ``last_only``), cache or None, aux loss): the reference's triple.  The
    cache's ``pos`` is a host int; an encoder-decoder's cache holds the
    cross K/V under ``enc``.

    ``remat`` ("none" | "full" | "2level" | "dots") checkpoints each
    block's activations as the reference's ``_remat``: "2level" groups the
    blocks by the divisor of their count nearest its square root and
    checkpoints each group around its checkpointed blocks (more than 3
    blocks; otherwise as "full").  It applies while autograd records and
    no cache is asked for; every mode gives the same loss and gradients.
    ``chunked`` takes the recurrences' differentiable training route.
    The encoder is not checkpointed, as in the reference.  ``mesh``
    reaches the MoE FFNs (``moe_ffn``)."""
    if remat not in ("none", "full", "2level", "dots"):
        raise ValueError(remat)
    n_full, pat, tail = stack_structure(cfg)
    x = _embed(params, tokens, mesh)
    enc_out = None
    if frontend_embeds is not None and cfg.frontend == "vision":
        fe = _act(_project_frontend(params, frontend_embeds), mesh)
        x = torch.cat([fe.to(x.dtype), x], dim=1)
    if frontend_embeds is not None and cfg.is_encdec:
        enc_out = encode(params, frontend_embeds, cfg, mesh=mesh,
                         q_chunk=q_chunk)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device).expand(B, T)
    blocks = {sn: _unbind(params["blocks"][sn], n_full)
              for sn in (slot_name(i, kind) for i, kind in enumerate(pat))
              } if n_full else {}
    block_caches = {slot_name(i, kind): [] for i, kind in enumerate(pat)}

    def block_body(x, aux, bi):
        caches = {}
        for i, kind in enumerate(pat):
            sn = slot_name(i, kind)
            x, c, a = apply_block_seq(x, blocks[sn][bi], cfg, kind,
                                      positions, mesh=mesh,
                                      want_cache=want_cache,
                                      enc_out=enc_out, q_chunk=q_chunk,
                                      chunked=chunked)
            aux = aux + a
            caches[sn] = c
        return x, aux, caches

    aux_total = _zero(x)
    policy = remat if not want_cache and torch.is_grad_enabled() else "none"
    if policy == "2level" and n_full > 3:
        g = _group_factor(n_full)
        inner = _remat(lambda x, aux, bi: block_body(x, aux, bi)[:2], "full")

        def group_body(x, aux, gi):
            for bi in range(gi * g, (gi + 1) * g):
                x, aux = inner(x, aux, bi)
            return x, aux

        outer = _remat(group_body, "full")
        for gi in range(n_full // g):
            x, aux_total = outer(x, aux_total, gi)
    else:
        body = _remat(block_body, policy)
        for bi in range(n_full):
            x, aux_total, c = body(x, aux_total, bi)
            if want_cache:
                for sn, cs in c.items():
                    block_caches[sn].append(cs)
    caches: dict = {"pos": T, "blocks": {}}
    if want_cache and n_full:
        caches["blocks"] = {sn: _stack(cs) for sn, cs in block_caches.items()}
    for i, kind in enumerate(tail):
        x, c, a = apply_block_seq(x, params["tail"][i], cfg, kind, positions,
                                  mesh=mesh, want_cache=want_cache,
                                  enc_out=enc_out,
                                  q_chunk=q_chunk, chunked=chunked)
        aux_total = aux_total + a
        if want_cache:
            caches.setdefault("tail", []).append(c)
    if want_cache and enc_out is not None:
        caches["enc"] = _enc_cross_cache(params, enc_out, cfg)
    if last_only:  # prefill: only the last position's logits are needed
        x = x[:, -1:, :]
    return (_readout(params, x, cfg), (caches if want_cache else None),
            aux_total)


def _project_frontend(params, frontend_embeds):
    """The stub frontend: precomputed embeddings through ``frontend_proj``
    (in the parameters' dtype)."""
    proj = params["frontend_proj"]
    return frontend_embeds.to(proj.dtype) @ proj


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, mesh=None,
           q_chunk: int = 1024) -> torch.Tensor:
    """The whisper-style encoder over precomputed frame embeddings
    [B,Te,D]: ``frontend_proj``, the non-causal ``attn`` blocks with RoPE
    on positions 0..Te-1, then ``enc_norm``.  Returns [B,Te,D]."""
    x = _act(_project_frontend(params, frames), mesh)
    B, Te, _ = x.shape
    positions = torch.arange(Te, device=x.device).expand(B, Te)
    for p in _unbind(params["encoder"], cfg.encoder_layers):
        x, _, _ = attn_block_seq(x, p, cfg, "attn", positions, mesh=mesh,
                                 causal=False, q_chunk=q_chunk)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_cross_cache(params, enc_out, cfg: ModelConfig) -> dict:
    """Every decoder block's cross-attention K/V of ``enc_out``, stacked
    over the decoder's blocks: {"k","v"} [n_full, B, Te, KV, hd]."""
    n_full = stack_structure(cfg)[0]
    px = params["blocks"][slot_name(0, "attn")]["xattn"]
    kv = [_cross_kv(enc_out, _index(px, bi), cfg) for bi in range(n_full)]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def decode_step(params, cache, token: torch.Tensor, cfg: ModelConfig, *,
                mesh=None):
    """One decode step.  token: [B,1] integer.  Returns (logits [B,1,V],
    cache): the cache is updated in place and returned.  Block ``i`` of
    an encoder-decoder cross-attends to ``cache["enc"]``'s slice ``i``,
    which stays as it is; the tail gets none, as in the reference."""
    n_full, pat, tail = stack_structure(cfg)
    pos = cache["pos"]
    enc = cache.get("enc")
    x = _embed(params, token, mesh)
    for bi in range(n_full):
        enc_bi = None if enc is None else _index(enc, bi)
        for i, kind in enumerate(pat):
            sn = slot_name(i, kind)
            stacked = cache["blocks"][sn]
            x, c = apply_block_decode(x, _index(params["blocks"][sn], bi),
                                      _index(stacked, bi), cfg, kind, pos,
                                      mesh=mesh, enc_cache=enc_bi)
            _store(stacked, bi, c)
    for i, kind in enumerate(tail):
        x, cache["tail"][i] = apply_block_decode(
            x, params["tail"][i], cache["tail"][i], cfg, kind, pos,
            mesh=mesh)
    cache["pos"] = pos + 1
    return _readout(params, x, cfg), cache
