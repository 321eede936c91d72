"""The hand-written Hopper blur kernel (``csrc/blur.cu``) bound to PyTorch.

Replaces the reference's Pallas ``blur_rows_pallas``
(``repro/kernels/blur/kernel.py``).  The CUDA source carries the design
note: one launch per run of row blocks, a thread a 2-column strip over
several rows, median bitwise against the reference's network.  This
module plans the launch, checks device, dtype, shapes and strides,
launches on the current stream, raises if the launch was refused, and
counts launches per body in ``LAUNCHES`` and the row blocks they covered
in ``ROW_BLOCKS``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.native import LaunchCounter, load_library

KINDS = {"median": 0, "gaussian": 1}
LAUNCHES = LaunchCounter()
ROW_BLOCKS = LaunchCounter()
THREADS, COLS = 128, 2           # a block: 128 threads of 2 columns each
ROWS_PER_THREAD = (8, 4, 2, 1)   # the kernel's instantiations
# blocks a launch should keep: about 4 a SM.  Measured on the H100
# (chip_smoke.py phase 5 times every rows-per-thread at the 256-row run):
# 8 rows a thread (512 blocks) beat 4, 2 and 1; a single 32-row block, at
# most 512 blocks, is fastest with 1.
MIN_BLOCKS = 512


def _lib():
    lib = load_library("blur")
    fn = lib.blur_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong] + [ctypes.c_int] * 5 + [
                           ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rows_per_thread(rows: int, width: int) -> int:
    """The most rows a thread walks while the launch keeps ``MIN_BLOCKS``
    blocks; 1 when no choice does."""
    threads = -(-width // COLS)
    col_blocks = -(-threads // THREADS)
    for r in ROWS_PER_THREAD:
        if col_blocks * -(-rows // r) >= MIN_BLOCKS:
            return r
    return ROWS_PER_THREAD[-1]


def _check(t: torch.Tensor, what: str):
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{what} must be 2-D with unit column stride, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def launch(src: torch.Tensor, dst: torch.Tensor, kind: str,
           row_blocks: int = 1):
    """Blur ``src`` ([rows+2, W+2], halo included) into ``dst`` ([rows, W])
    on the current stream, one launch counted as ``row_blocks`` row
    blocks.  Both may be views with any row stride."""
    if kind not in KINDS:
        raise ValueError(f"unknown blur kind {kind!r}; known: {sorted(KINDS)}")
    _check(src, "src")
    _check(dst, "dst")
    rows, width = dst.shape
    if tuple(src.shape) != (rows + 2, width + 2):
        raise ValueError(f"src {tuple(src.shape)} is not dst {(rows, width)} "
                         f"plus a 1-pixel halo")
    if src.device != dst.device:
        raise ValueError(f"src on {src.device}, dst on {dst.device}")
    per_thread = rows_per_thread(rows, width)
    vec = int(src.data_ptr() % 8 == 0 and src.stride(0) % 2 == 0)
    fn = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = fn(src.data_ptr(), src.stride(0), dst.data_ptr(), dst.stride(0),
             rows, width, KINDS[kind], per_thread, vec, stream)
    if err != 0:
        raise RuntimeError(f"blur_rows launch failed: CUDA error {err}")
    LAUNCHES.inc(kind)
    ROW_BLOCKS.inc(kind, row_blocks)


def blur_rows(src_padded: torch.Tensor, dst_padded: torch.Tensor, row0: int,
              row_block: int, kind: str, n_blocks: int = 1):
    """In place, ``n_blocks`` consecutive row blocks in one launch: read
    ``src_padded`` rows ``row0 .. row0 + n_blocks*RB + 1`` and write
    ``dst_padded[row0+1 : row0+n_blocks*RB+1, 1 : W+1]``."""
    w = src_padded.shape[1] - 2
    rows = n_blocks * row_block
    launch(src_padded[row0:row0 + rows + 2],
           dst_padded[row0 + 1:row0 + rows + 1, 1:w + 1], kind, n_blocks)


def blur_block(block: torch.Tensor, kind: str) -> torch.Tensor:
    """Functional form: padded ``[RB+2, W+2]`` -> blurred interior
    ``[RB, W]`` in a fresh tensor."""
    out = torch.empty((block.shape[0] - 2, block.shape[1] - 2),
                      dtype=block.dtype, device=block.device)
    launch(block, out, kind)
    return out
