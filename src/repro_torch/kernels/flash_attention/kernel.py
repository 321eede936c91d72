"""The hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``) bound to PyTorch.

Replaces the reference's Pallas ``flash_attention_pallas``
(``repro/kernels/flash_attention/kernel.py``).  The CUDA source carries the
design note.  This module plans the launch (``plan``), checks device,
dtype, shapes and strides, launches on the current stream, raises if the
launch was refused, and counts launches in ``LAUNCHES`` (key ``"flash"``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.native import LaunchCounter, load_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
LAUNCHES = LaunchCounter()
ROWS = 16                  # query rows a block: heads x positions
KEYS_PER_PASS = 128        # keys a block stages and scores at once

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


class Plan(NamedTuple):
    heads_per_block: int   # heads of a GQA group that share a block's K/V
    positions: int         # consecutive query positions a block takes


def plan(B: int, H: int, KV: int, T: int, S: int, hd: int) -> Plan:
    """Heads per block: the most of 16, 8, 4, 2, 1 that divides the group,
    so each staged K/V row serves as many heads as a block can hold; the
    rest of the block's 16 rows are consecutive positions."""
    group = H // KV
    g = next(g for g in (16, 8, 4, 2, 1) if group % g == 0)
    return Plan(g, ROWS // g)


def _lib():
    fn = load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([_P, _LL, _LL, _LL] * 3 + [_P] + [_I] * 6
                       + [_I, _I, _I, _F, _I, _I, _P])
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, device):
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype} like q, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{what} must be 4-D with unit stride on the head "
                         f"dim, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int], q_offset: int,
           scale: float) -> torch.Tensor:
    """q [B,H,T,hd], k/v [B,KV,S,hd] (any strides but the head dim's) ->
    a fresh contiguous [B,H,T,hd] in q's dtype, on the current stream."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, what, q.dtype, q.device)
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, S, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as [B,KV,S,hd]")
    if min(B, H, T, KV, S, hd) < 1 or H % KV:
        raise ValueError(f"need H % KV == 0 and non-empty dims, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    o = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
                 v.data_ptr(), *v.stride()[:3], o.data_ptr(), B, H, KV, T, S,
                 hd, int(q_offset), int(bool(causal)),
                 -1 if window is None else int(window), float(scale),
                 DTYPES[q.dtype], plan(B, H, KV, T, S, hd).heads_per_block,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.inc("flash")
    return o
