"""The hand-written Hopper decode-attention kernel
(``csrc/decode_attention.cu``) bound to PyTorch.

Replaces the reference's Pallas ``decode_attention_pallas``
(``repro/kernels/decode_attention/kernel.py``) and, in the paged entry, the
XLA page gather before it.  The CUDA source carries the design note.  This
module plans the launch (``plan``), checks device, dtype, shapes and
strides, launches on the current stream, raises if the launch was refused,
and counts launches in ``LAUNCHES`` (keys ``"contiguous"`` and ``"paged"``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.native import LaunchCounter, load_library

MAX_KEYS_AND_HEAD_DIM = 12 * 1024  # keys + head dim the wrapper accepts
LAUNCHES = LaunchCounter()
MAX_WARPS = 8
TILE = 128                 # output dims a block covers
SMEM_BYTES = 232448        # shared memory a block can have on an H100

_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


class Plan(NamedTuple):
    heads_per_block: int   # query heads of a group that share a block's loads
    warps: int             # warps a block, each a contiguous slice of keys


def _keys_per_step(heads_per_block: int) -> int:
    return 4 if heads_per_block >= 8 else 8


def smem_bytes(heads_per_block: int, warps: int, hd: int, slots: int) -> int:
    """Dynamic shared memory of a block, as ``csrc/decode_attention.cu``
    lays it out: queries, per-warp softmax states, score tiles, and
    (paged: ``slots`` = S) each slot's pool row."""
    g = heads_per_block
    return 4 * (-(-g * hd // 4) * 4 + warps * g * (TILE + 4)
                + warps * _keys_per_step(g) * g + slots)


def plan(B: int, H: int, KV: int, S: int, hd: int, paged: bool = False
         ) -> Plan:
    """Heads per block: the most of 8, 4, 2, 1 that divides the group and
    fits the shared memory.  Warps: enough for one step of keys each, at
    most 8."""
    group = H // KV
    g = next(g for g in (8, 4, 2, 1)
             if group % g == 0
             and smem_bytes(g, MAX_WARPS, hd, S if paged else 0) <= SMEM_BYTES)
    kc = _keys_per_step(g)
    warps = max(1, min(MAX_WARPS, -(-S // kc)))
    return Plan(g, warps)


def _lib():
    lib = load_library("decode_attention")
    dense, paged = lib.decode_attention_fwd, lib.paged_decode_attention_fwd
    if dense.argtypes is None:
        dense.argtypes = ([_P, _LL, _LL] + [_P, _LL, _LL, _LL] * 2
                          + [_P, _P] + [_I] * 6 + [_F] + [_I] * 3 + [_P])
        dense.restype = ctypes.c_int
        paged.argtypes = ([_P, _LL, _LL, _P, _P, _P, _LL, _I, _I, _I, _P, _P]
                          + [_I] * 5 + [_F] + [_I] * 3 + [_P])
        paged.restype = ctypes.c_int
    return dense, paged


def _vec(hd: int, tensors, strides) -> int:
    """1 when every row a lane reads as a float4 starts 16-byte aligned."""
    return int(hd % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
               and all(st % 4 == 0 for st in strides))


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, device, dim: int):
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != dim or t.stride(-1) != 1:
        raise ValueError(f"{what} must be {dim}-D with unit last stride, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def _positions(pos, B: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        _check(pos, "pos", torch.int32, device, 1)
        if pos.shape[0] != B:
            raise ValueError(f"pos has {pos.shape[0]} rows, q has {B}")
        return pos
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def _common(q: torch.Tensor, window: Optional[int]):
    _check(q, "q", torch.float32, q.device, 4)
    if q.shape[2] != 1:
        raise ValueError(f"q must be [B,H,1,hd], got {tuple(q.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    return -1 if window is None else int(window)


def _finish(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    LAUNCHES.inc(what)


def _check_sizes(H: int, KV: int, S: int, hd: int):
    if min(H, KV, S, hd) < 1 or H % KV:
        raise ValueError(f"need H % KV == 0 and non-empty dims, got H={H} "
                         f"KV={KV} S={S} hd={hd}")
    if S + hd > MAX_KEYS_AND_HEAD_DIM:
        raise ValueError(f"{S} keys + head dim {hd} exceed "
                         f"{MAX_KEYS_AND_HEAD_DIM}")


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos, *, window: Optional[int], scale: float) -> torch.Tensor:
    """Contiguous (ring or linear) caches [B,KV,S,hd], any strides but the
    head dim's -> a fresh [B,H,1,hd] f32, on the current stream."""
    win = _common(q, window)
    B, H, _, hd = q.shape
    for t, what in ((k_cache, "k_cache"), (v_cache, "v_cache")):
        _check(t, what, torch.float32, q.device, 4)
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if (tuple(k_cache.shape) != (B, KV, S, hd)
            or tuple(v_cache.shape) != tuple(k_cache.shape)):
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)} as [B,KV,S,hd]")
    _check_sizes(H, KV, S, hd)
    p = _positions(pos, B, q.device)
    o = torch.empty((B, H, 1, hd), dtype=torch.float32, device=q.device)
    pl = plan(B, H, KV, S, hd)
    vec = _vec(hd, (k_cache, v_cache),
               k_cache.stride()[:3] + v_cache.stride()[:3])
    dense, _ = _lib()
    err = dense(q.data_ptr(), q.stride(0), q.stride(1),
                k_cache.data_ptr(), *k_cache.stride()[:3],
                v_cache.data_ptr(), *v_cache.stride()[:3],
                p.data_ptr(), o.data_ptr(), B, H, KV, S, hd, win, float(scale),
                *pl, vec, torch.cuda.current_stream(q.device).cuda_stream)
    _finish(err, "contiguous")
    return o


def launch_paged(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables: torch.Tensor, pos, *, window: Optional[int],
                 scale: float) -> torch.Tensor:
    """Contiguous pools [NB,BS,KV,hd], tables i32[B,T_blk] (unit column
    stride; rows may be strided) -> a fresh [B,H,1,hd] f32.  The block-table
    walk runs inside the kernel."""
    win = _common(q, window)
    B, H, _, hd = q.shape
    for t, what in ((k_pool, "k_pool"), (v_pool, "v_pool")):
        _check(t, what, torch.float32, q.device, 4)
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    NB, BS, KV = k_pool.shape[:3]
    if (tuple(k_pool.shape) != (NB, BS, KV, hd)
            or tuple(v_pool.shape) != tuple(k_pool.shape)):
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as [NB,BS,KV,hd]")
    if NB * BS * KV >= 2 ** 31:
        raise ValueError(f"pools of {NB * BS * KV} rows exceed the kernel's "
                         f"int32 row index")
    _check(tables, "tables", torch.int32, q.device, 2)
    if tables.shape[0] != B:
        raise ValueError(f"tables has {tables.shape[0]} rows, q has {B}")
    T_blk = tables.shape[1]
    _check_sizes(H, KV, T_blk * BS, hd)
    p = _positions(pos, B, q.device)
    o = torch.empty((B, H, 1, hd), dtype=torch.float32, device=q.device)
    pl = plan(B, H, KV, T_blk * BS, hd, paged=True)
    vec = _vec(hd, (k_pool, v_pool), ())
    _, paged = _lib()
    err = paged(q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
                v_pool.data_ptr(), tables.data_ptr(), tables.stride(0), T_blk,
                NB, BS, p.data_ptr(), o.data_ptr(), B, H, KV, hd, win,
                float(scale), *pl, vec,
                torch.cuda.current_stream(q.device).cuda_stream)
    _finish(err, "paged")
    return o
