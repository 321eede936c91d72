"""The hand-written Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``)
bound to PyTorch.

Replaces the reference's Pallas ``rglru_scan_pallas``
(``repro/kernels/rglru_scan/kernel.py``).  The CUDA source carries the
design note.  This module checks device, dtype, shapes and strides,
launches on the current stream, raises if the launch was refused, and
counts launches in ``LAUNCHES`` (key ``"rglru"``).  Unlike the reference's
wrapper, the channel dim is not padded to 128 lanes: the kernel
bounds-checks its last channel block.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.native import (LaunchCounter, check_tensor,
                                        load_library)

LAUNCHES = LaunchCounter()

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    fn = load_library("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _P,
                       _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def launch(a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b f32 [B,T,L]; h0 f32 [B,L] or None (zeros) -> fresh contiguous
    (h_seq [B,T,L], h_last [B,L]), on the current stream."""
    if a.dim() != 3:
        raise ValueError(f"a must be [B,T,L], got shape {tuple(a.shape)}")
    B, T, L = a.shape
    check_tensor(a, "a", (B, T, L), a.device, torch.float32)
    check_tensor(b, "b", (B, T, L), a.device, torch.float32)
    if h0 is not None:
        check_tensor(h0, "h0", (B, L), a.device, torch.float32)
    if min(B, T, L) < 1:
        raise ValueError(f"empty scan: a {tuple(a.shape)}")
    hs = torch.empty((B, T, L), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, L), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib()(a.data_ptr(), a.stride(0), a.stride(1),
                 b.data_ptr(), b.stride(0), b.stride(1),
                 None if h0 is None else h0.data_ptr(),
                 0 if h0 is None else h0.stride(0),
                 hs.data_ptr(), h_last.data_ptr(), B, T, L, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: CUDA error {err}")
    LAUNCHES.inc("rglru")
    return hs, h_last
