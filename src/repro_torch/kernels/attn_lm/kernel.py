"""The persistent attention-LM serving kernels (``csrc/attn_lm.cu``) bound
to PyTorch: M4, ``attn_prefill_mega``, and M5, ``attn_decode_mega``.

Counterparts of the reference's ``make_megakernel`` over ``attn_prefill``
and ``attn_decode`` (``repro/core/preemption.py``,
``repro/serving/attention.py``): one cooperative launch runs an attention-LM
task's remaining chunk loop on the card, B2's (M4) or B3's (M5) device code
and the projections and readout inside it, and polls the region's mapped
preempt flag at every chunk boundary.  This module checks device, dtype,
shapes and strides, launches on the current stream, raises if the launch
was refused, and counts launches per kernel in ``MEGA_LAUNCHES``; the
chunk-body iterations (segments, steps) the device reports it ran go to
``STEPS`` when the launch's result is read.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.native import (LaunchCounter, check_tensor,
                                        load_library)
from repro_torch.kernels.seq_lm.kernel import (MAX_SLOTS, MegaLaunch,
                                               launch_persistent,
                                               persistent_words)

MEGA_LAUNCHES = LaunchCounter()
STEPS = LaunchCounter()
MAX_ROWS = MAX_SLOTS          # prefill rows (PB) and decode slots (S)
MAX_HEAD_DIM = FK.MAX_HEAD_DIM


class Geometry(NamedTuple):
    """``AttentionParams``' model and paging geometry, as ints."""
    d_model: int
    vocab: int
    n_heads: int
    kv_heads: int
    head_dim: int
    block_size: int
    max_ctx: int


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
_PREFILL_ARGS = ([_P, _P, _L, _P, _P, _P, _L, _P, _L, _P, _P, _L] + [_I] * 10
                 + [_F, _I, _I] + [_P] * 3 + [_I, _P])
_DECODE_ARGS = ([_P, _P, _L, _P, _P, _I, _I, _P, _L, _I, _P, _P, _L]
                + [_I] * 10 + [_F, _I, _I] + [_P] * 3 + [_I, _P])


def _lib():
    lib = load_library("attn_lm")
    if lib.attn_prefill_mega.argtypes is None:
        lib.attn_lm_workspace.argtypes = [_I] * 5
        lib.attn_lm_workspace.restype = _L
        lib.attn_lm_grid.argtypes = [_I] * 6 + [_P]
        lib.attn_lm_grid.restype = _I
        lib.attn_decode_mega.argtypes = _DECODE_ARGS
        lib.attn_decode_mega.restype = _I
        lib.attn_prefill_mega.argtypes = _PREFILL_ARGS
        lib.attn_prefill_mega.restype = _I
    return lib


def _check_geometry(g: Geometry):
    if min(g) < 1 or g.n_heads % g.kv_heads or g.max_ctx % g.block_size:
        raise ValueError(f"geometry {g}: every field >= 1, heads a multiple "
                         f"of KV heads, max_ctx a multiple of block_size")
    if g.head_dim > MAX_HEAD_DIM or g.head_dim % 4 or g.d_model % 4:
        raise ValueError(f"head dim {g.head_dim} (at most {MAX_HEAD_DIM}) and "
                         f"d_model {g.d_model} must be multiples of 4")


def weight_rows(g: Geometry) -> int:
    """Rows of the flat weights: E, pos_emb, Wq^T, Wk^T, Wv^T, Wo."""
    return g.vocab + g.max_ctx + 2 * (g.n_heads + g.kv_heads) * g.head_dim


def _common(g: Geometry, weights: torch.Tensor):
    _check_geometry(g)
    device = weights.device
    check_tensor(weights, "weights", (weight_rows(g), g.d_model), device,
                 torch.float32)
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    return device


def _check_kv(t: torch.Tensor, what: str, shape, device):
    check_tensor(t, what, shape, device, torch.float32)
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def prefill_rows(PB: int, g: Geometry, budget: int) -> int:
    """The rows of M4's chunk at ``budget``: ``min(budget, segments)``
    segments of ``PB`` rows x ``block_size`` positions.  M4 projects them
    together, so its workspace holds a whole chunk's x, q and o."""
    return min(budget, g.max_ctx // g.block_size) * PB * g.block_size


def _workspace(rows: int, emit: int, g: Geometry, device) -> torch.Tensor:
    n = _lib().attn_lm_workspace(rows, emit, g.d_model, g.n_heads,
                                 g.head_dim)
    if n < 0:
        raise ValueError(f"no workspace for {rows} rows, {emit} emitting")
    return torch.empty(n, dtype=torch.float32, device=device)


def grid(decode: bool, g: Geometry, slots: int, device) -> Tuple[int, ...]:
    """(grid, cap, co-resident blocks) of an M4 (``decode=False``) or M5
    launch at ``g`` on ``device``, as the launch sizes it."""
    gt, warps = DK.plan(slots, g.n_heads, g.kv_heads, g.max_ctx, g.head_dim,
                        paged=True)
    info = (ctypes.c_int * 3)()
    err = _lib().attn_lm_grid(int(decode), g.head_dim, gt, warps, g.max_ctx,
                              torch.device(device).index or 0, info)
    if err != 0:
        raise RuntimeError(f"attn_lm_grid failed: CUDA error {err}")
    return tuple(info)


def attn_prefill_mega(ctx_words, out: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, prompt: torch.Tensor,
                      meta: torch.Tensor, weights: torch.Tensor, g: Geometry,
                      budget: int, flag) -> MegaLaunch:
    """Launch M4 on the current stream: AttnPrefill's segments from the
    context ``ctx_words`` (out i32[PB, W], k_new/v_new f32[PB, P, KV, hd],
    prompt i32[PB, P], meta i32[PB, W'] with prompt_len in col 0, the flat
    weights), a segment per budget unit, chunks of ``budget``, until done
    or the first boundary ``k >= flag``.  Returns at once."""
    words = persistent_words(ctx_words, budget, flag)
    device = _common(g, weights)
    if prompt.dim() != 2 or out.dim() != 2 or meta.dim() != 2:
        raise ValueError(f"prompt {tuple(prompt.shape)}, out "
                         f"{tuple(out.shape)}, meta {tuple(meta.shape)} must "
                         f"be 2-D")
    PB, P = prompt.shape
    check_tensor(prompt, "prompt", (PB, P), device, torch.int32)
    check_tensor(out, "out", (PB, out.shape[1]), device, torch.int32)
    check_tensor(meta, "meta", (PB, meta.shape[1]), device, torch.int32)
    kv = (PB, P, g.kv_heads, g.head_dim)
    _check_kv(k_new, "k_new", kv, device)
    _check_kv(v_new, "v_new", kv, device)
    if not 1 <= PB <= MAX_ROWS or P != g.max_ctx or min(out.shape[1],
                                                         meta.shape[1]) < 1:
        raise ValueError(f"PB {PB} (at most {MAX_ROWS}), P {P} (max_ctx "
                         f"{g.max_ctx}), out and meta with a column")
    hpb = FK.plan(PB, g.n_heads, g.kv_heads, g.block_size, P,
                  g.head_dim).heads_per_block
    ws = _workspace(prefill_rows(PB, g, budget), PB, g, device)
    # every chunk but the last runs at least one segment
    max_chunks = P // g.block_size + 2
    return launch_persistent(
        "AttnPrefill", _lib().attn_prefill_mega,
        (words.ctypes.data, out.data_ptr(), out.stride(0), k_new.data_ptr(),
         v_new.data_ptr(), prompt.data_ptr(), prompt.stride(0),
         meta.data_ptr(), meta.stride(0), weights.data_ptr(), ws.data_ptr(),
         ws.numel(), PB, P, g.d_model, g.vocab, g.n_heads, g.kv_heads,
         g.head_dim, g.block_size, g.max_ctx, hpb,
         1.0 / math.sqrt(g.head_dim), int(budget), max_chunks),
        (out, k_new, v_new, prompt, meta, weights, ws), flag, MEGA_LAUNCHES,
        STEPS)


def attn_decode_mega(ctx_words, out: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, table: torch.Tensor,
                     weights: torch.Tensor, g: Geometry, budget: int,
                     flag) -> MegaLaunch:
    """Launch M5 on the current stream: AttnDecode's R steps over the S
    slot rows from the context ``ctx_words`` (out i32[S, R], pools
    f32[NB, BS, KV, hd], table i32[S, 4 + max_ctx / BS], updated in place,
    the flat weights), a step per budget unit, chunks of ``budget``, until
    done or the first boundary ``k >= flag``.  Returns at once."""
    # the table's layout is serving's (which imports this module)
    from repro_torch.serving.attention import TABLE_META

    words = persistent_words(ctx_words, budget, flag)
    device = _common(g, weights)
    if out.dim() != 2 or k_pool.dim() != 4:
        raise ValueError(f"out {tuple(out.shape)} must be 2-D and k_pool "
                         f"{tuple(k_pool.shape)} 4-D")
    (S, R), NB = out.shape, k_pool.shape[0]
    T_blk = g.max_ctx // g.block_size
    check_tensor(out, "out", (S, R), device, torch.int32)
    check_tensor(table, "table", (S, TABLE_META + T_blk), device, torch.int32)
    pool = (NB, g.block_size, g.kv_heads, g.head_dim)
    _check_kv(k_pool, "k_pool", pool, device)
    _check_kv(v_pool, "v_pool", pool, device)
    if not 1 <= S <= MAX_ROWS or NB * g.block_size * g.kv_heads >= 2 ** 31:
        raise ValueError(f"S {S} (at most {MAX_ROWS}), pools of "
                         f"{NB * g.block_size * g.kv_heads} rows (fewer than "
                         f"2^31)")
    gt, warps = DK.plan(S, g.n_heads, g.kv_heads, T_blk * g.block_size,
                        g.head_dim, paged=True)
    ws = _workspace(S, S, g, device)
    max_chunks = R + 2
    return launch_persistent(
        "AttnDecode", _lib().attn_decode_mega,
        (words.ctypes.data, out.data_ptr(), out.stride(0), k_pool.data_ptr(),
         v_pool.data_ptr(), NB, g.block_size, table.data_ptr(),
         table.stride(0), T_blk, weights.data_ptr(), ws.data_ptr(),
         ws.numel(), S, R, g.d_model, g.vocab, g.n_heads, g.kv_heads,
         g.head_dim, g.max_ctx, gt, warps, 1.0 / math.sqrt(g.head_dim),
         int(budget), max_chunks),
        (out, k_pool, v_pool, table, weights, ws), flag, MEGA_LAUNCHES, STEPS)
