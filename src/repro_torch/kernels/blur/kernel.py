"""The hand-written Hopper blur kernel (``csrc/blur.cu``) bound to PyTorch.

Replaces the reference's Pallas ``blur_rows_pallas``
(``repro/kernels/blur/kernel.py``).  The CUDA source carries the design
note: one launch per run of row blocks, a thread a 2-column strip over
several rows, median bitwise against the reference's network.  This
module plans the launch, checks device, dtype, shapes and strides,
launches on the current stream, raises if the launch was refused, and
counts launches per body in ``LAUNCHES`` and the row blocks they covered
in ``ROW_BLOCKS``.

``blur_mega`` is the megakernel engine's persistent entry (M1, the
counterpart of the reference's ``make_megakernel`` over a blur task): one
cooperative launch runs the task's remaining chunk loop on the card and
polls the region's mapped preempt flag at every chunk boundary.  It counts
``MEGA_LAUNCHES`` at launch; the row blocks the device reports it ran go to
``ROW_BLOCKS`` when the launch's result is read.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.context import CTX_WORDS
from repro_torch.kernels.native import LaunchCounter, load_library

KINDS = {"median": 0, "gaussian": 1}
LAUNCHES = LaunchCounter()
ROW_BLOCKS = LaunchCounter()
MEGA_LAUNCHES = LaunchCounter()
ROW_BLOCK = 32
MEGA_ROWS = 8                    # output rows a thread per tile (kMegaRows)
# out[] layout of csrc/blur.cu: the context words, then these
OUT_CHUNKS, OUT_ROW_BLOCKS, OUT_TILES, OUT_STATUS = (
    CTX_WORDS, CTX_WORDS + 1, CTX_WORDS + 2, CTX_WORDS + 3)
OUT_WORDS = CTX_WORDS + 6
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


def _mega_lib():
    lib = load_library("blur")
    fn = lib.blur_mega
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def tiles_per_row_block(width: int) -> int:
    """M1's tiles in one row block: column blocks x row groups."""
    pairs = -(-width // COLS)
    return -(-pairs // THREADS) * (ROW_BLOCK // MEGA_ROWS)


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


class MegaLaunch:
    """One persistent launch in flight: ``query()`` polls the event
    recorded after it; ``result()`` waits for it, reads the words the
    kernel wrote back and returns ``(context words, n_chunks)``.  The
    first ``result()`` checks the device's report (no chunk cap hit; the
    tiles the blocks ran add up to the row blocks its control issued) and
    adds those row blocks to ``ROW_BLOCKS``.  ``grid`` holds the launch's
    blocks, their cap and the blocks the card holds at once
    (``csrc/blur.cu``, ``launch_mega``)."""

    def __init__(self, out: torch.Tensor, event, kind: str, width: int,
                 grid: dict, flag):
        self._out, self._event, self._kind, self._width = (
            out, event, kind, width)
        self.grid = grid
        self._flag = flag  # the kernel reads it until the event
        self._res: Optional[tuple] = None

    def query(self) -> bool:
        return self._event.query()

    def result(self):
        if self._res is None:
            self._event.synchronize()
            w = self._out.cpu().numpy()
            if w[OUT_STATUS] != 0:
                raise RuntimeError(f"blur_mega ran {w[OUT_CHUNKS]} chunks "
                                   f"without finishing the task: its "
                                   f"control flow is broken")
            blocks = int(w[OUT_ROW_BLOCKS])
            tiles = int(w[OUT_TILES])
            if tiles != blocks * tiles_per_row_block(self._width):
                raise RuntimeError(
                    f"blur_mega's blocks ran {tiles} tiles for {blocks} row "
                    f"blocks ({tiles_per_row_block(self._width)} a block)")
            ROW_BLOCKS.inc(self._kind, blocks)
            self._res = (w[:CTX_WORDS].copy(), int(w[OUT_CHUNKS]))
        return self._res


def blur_mega(ctx_words, ping: torch.Tensor, pong: torch.Tensor, kind: str,
              iters: int, budget: int, flag) -> MegaLaunch:
    """Launch M1 on the current stream: the blur task's chunk loop over
    the padded ping/pong images (``[H+2, W+2]``, H a multiple of 32), from
    the context ``ctx_words`` (``CTX_WORDS`` int32) with chunks of
    ``budget`` row-block units, until done or the first boundary ``k >=
    flag`` (``flag``: a ``PreemptFlag`` on the card).  Returns at once."""
    if kind not in KINDS:
        raise ValueError(f"unknown blur kind {kind!r}; known: {sorted(KINDS)}")
    _check(ping, "ping")
    _check(pong, "pong")
    if ping.shape != pong.shape or ping.stride() != pong.stride() \
            or ping.device != pong.device:
        raise ValueError(f"ping {tuple(ping.shape)} {ping.stride()} on "
                         f"{ping.device} and pong {tuple(pong.shape)} "
                         f"{pong.stride()} on {pong.device} differ")
    h, width = ping.shape[0] - 2, ping.shape[1] - 2
    if h <= 0 or h % ROW_BLOCK or width <= 0:
        raise ValueError(f"images {tuple(ping.shape)} are not [H+2, W+2] "
                         f"with H a positive multiple of {ROW_BLOCK}")
    if budget < 1 or iters < 0:
        raise ValueError(f"budget {budget} < 1 or iters {iters} < 0")
    words = np.ascontiguousarray(ctx_words, np.int32)
    if words.shape != (CTX_WORDS,):
        raise ValueError(f"context words {words.shape}, expected "
                         f"({CTX_WORDS},)")
    if not getattr(flag, "device_ptr", 0):
        raise ValueError("flag must be a PreemptFlag made for a CUDA device")
    n_rb = h // ROW_BLOCK
    vec = int(all(t.data_ptr() % 8 == 0 for t in (ping, pong))
              and ping.stride(0) % 2 == 0)
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=ping.device)
    info = (ctypes.c_int * 3)()
    stream = torch.cuda.current_stream(ping.device)
    # every chunk but the last runs at least one row block
    max_chunks = iters * n_rb + 2
    flag.set_progress(0)
    err = _mega_lib()(words.ctypes.data, ping.data_ptr(), pong.data_ptr(),
                      ping.stride(0), n_rb, width, int(iters), int(budget),
                      max_chunks, KINDS[kind], vec, flag.device_ptr,
                      flag.progress_ptr, out.data_ptr(),
                      ping.device.index or 0, info, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"blur_mega launch failed: CUDA error {err}")
    MEGA_LAUNCHES.inc(kind)
    event = torch.cuda.Event()
    event.record(stream)
    return MegaLaunch(out, event, kind, width,
                      {"grid": info[0], "cap": info[1],
                       "coresident": info[2]}, flag)
