"""The hand-written Hopper RWKV-6 recurrence kernel (``csrc/rwkv6.cu``)
bound to PyTorch.

Replaces the reference's Pallas ``rwkv6_pallas``
(``repro/kernels/rwkv6/kernel.py``).  The CUDA source carries the design
note.  This module checks device, dtype, shapes and strides, launches on
the current stream, raises if the launch was refused, and counts launches
in ``LAUNCHES`` (key ``"rwkv6"``).  The ``[B,T,H,hd]`` inputs are read in
place by their strides: the reference wrapper's transposes are TPU layout.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.native import (LaunchCounter, check_tensor,
                                        load_library)

MAX_HEAD_DIM = 64
LAUNCHES = LaunchCounter()

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    fn = load_library("rwkv6").rwkv6_fwd
    if fn.argtypes is None:
        fn.argtypes = ([_P, _LL, _LL, _LL] * 4 + [_P, _LL, _P, _LL, _LL, _LL,
                                                  _P, _P] + [_I] * 4 + [_P])
        fn.restype = ctypes.c_int
    return fn


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           logw: torch.Tensor, u: torch.Tensor,
           s0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw f32 [B,T,H,hd] (any strides but the head dim's); u f32
    [H,hd]; s0 f32 [B,H,hd,hd] or None (zeros) -> fresh contiguous
    (o [B,T,H,hd], s_last [B,H,hd,hd]), on the current stream."""
    if r.dim() != 4:
        raise ValueError(f"r must be [B,T,H,hd], got shape {tuple(r.shape)}")
    B, T, H, hd = r.shape
    for t, what in ((r, "r"), (k, "k"), (v, "v"), (logw, "logw")):
        check_tensor(t, what, (B, T, H, hd), r.device, torch.float32)
    check_tensor(u, "u", (H, hd), r.device, torch.float32)
    if s0 is not None:
        check_tensor(s0, "s0", (B, H, hd, hd), r.device, torch.float32)
    if min(B, T, H, hd) < 1:
        raise ValueError(f"empty recurrence: r {tuple(r.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    o = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    seqs = [x for t in (r, k, v, logw) for x in (t.data_ptr(), *t.stride()[:3])]
    s0_args = ((None, 0, 0, 0) if s0 is None
               else (s0.data_ptr(), *s0.stride()[:3]))
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib()(*seqs, u.data_ptr(), u.stride(0), *s0_args, o.data_ptr(),
                 s_last.data_ptr(), B, T, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_fwd launch failed: CUDA error {err}")
    LAUNCHES.inc("rwkv6")
    return o, s_last
