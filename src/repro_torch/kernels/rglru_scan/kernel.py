"""The hand-written Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``)
bound to PyTorch.

Replaces the reference's Pallas ``rglru_scan_pallas``
(``repro/kernels/rglru_scan/kernel.py``).  The CUDA source carries the
design note.  This module checks device, dtype, shapes and strides,
launches on the current stream, raises if the launch was refused, and
counts launches in ``LAUNCHES`` (key ``"rglru"``).  Unlike the reference's
wrapper, the channel dim is not padded to 128 lanes: the kernel
bounds-checks its last channel block.  ``plan`` and ``vector_width`` choose
the kernel's time segments and its channels per thread; they are plain
functions, so the CPU tests reach them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.native import (LaunchCounter, check_tensor,
                                        load_library)

LAUNCHES = LaunchCounter()
# kMaxSegments and kSegmentSteps in csrc/rglru_scan.cu: at most 8 segments
# (warps) a block, at most 16 steps a segment (the register depth)
MAX_SEGMENTS, SEGMENT_STEPS = 8, 16

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    fn = load_library("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _P,
                       _I, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def plan(T: int) -> Tuple[int, int]:
    """(P, S): the number of time segments of a tile and the steps of each.
    T = 1 is one segment of one step.  Otherwise as few segments of at most
    ``SEGMENT_STEPS`` steps as cover T, at most ``MAX_SEGMENTS``, with the
    steps spread evenly over them; a longer T loops over tiles of P*S."""
    if T <= 1:
        return 1, 1
    P = min(MAX_SEGMENTS, -(-T // SEGMENT_STEPS))
    return P, min(SEGMENT_STEPS, -(-T // P))


def vector_width(a: torch.Tensor, b: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> int:
    """Channels per thread of the segmented kernel: 4 (one float4) when L
    and every pointer and batch or time stride are whole float4s, else 1.
    (At T = 1 the kernel runs one channel a thread whatever this says.)"""
    tensors = [t for t in (a, b, h0) if t is not None]
    whole = a.shape[-1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:-1])
        for t in tensors)
    return 4 if whole else 1


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
                 hs.data_ptr(), h_last.data_ptr(), B, T, L, *plan(T),
                 vector_width(a, b, h0), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: CUDA error {err}")
    LAUNCHES.inc("rglru")
    return hs, h_last
