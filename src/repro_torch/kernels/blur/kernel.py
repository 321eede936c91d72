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
cooperative launch runs the task's remaining chunk loop on the card, a
watcher block reading the region's mapped preempt flag one chunk boundary
ahead.  ``mega_plan`` gives a launch's grid, its chunks' runs and the
grid-wide waits it takes (one where a pass ends and another run follows);
the launch is sized from it and its report checked against it.  It counts
``MEGA_LAUNCHES`` at launch; the row blocks the device reports it ran go to
``ROW_BLOCKS`` when the launch's result is read.  ``latency_probe`` times
the parts an M1 chunk is made of (``blur_latency_probe``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

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
# out[] layout of csrc/blur.cu: the context words, then these; two u64
# %globaltimer stamps (the first block's start as its complement, the last
# block's end); the words the blocks hand each other further on
OUT_CHUNKS, OUT_ROW_BLOCKS, OUT_TILES, OUT_STATUS, OUT_WAITS = (
    CTX_WORDS, CTX_WORDS + 1, CTX_WORDS + 2, CTX_WORDS + 3, CTX_WORDS + 4)
OUT_START, OUT_END = CTX_WORDS + 6, CTX_WORDS + 8
OUT_WORDS = 160
SLOT_K, SLOT_ROW = 0, 1          # kernels/blur/tasks.py
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
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _probe_lib():
    lib = load_library("blur")
    fn = lib.blur_latency_probe
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def tiles_per_row_block(width: int) -> int:
    """M1's tiles in one row block: column blocks x row groups."""
    pairs = -(-width // COLS)
    return -(-pairs // THREADS) * (ROW_BLOCK // MEGA_ROWS)


class Run(NamedTuple):
    """One pass's run of a chunk: row blocks ``first .. first + n_blocks
    - 1`` of pass ``k``; ``ends_pass`` when it reaches the pass's last."""
    k: int
    first: int
    n_blocks: int
    ends_pass: bool


@dataclass(frozen=True)
class MegaPlan:
    """What M1 does from one context: ``grid`` compute blocks (one tile a
    block in the largest run: ``run_blocks`` row blocks of
    ``tiles_per_row_block`` tiles), ``max_chunks`` the launch's guard,
    ``chunks()`` the runs of every chunk to the task's end, ``totals(n)``
    the row blocks and grid-wide waits of a launch that ran ``n`` chunks:
    a wait before each run that starts a pass after another run of the
    launch."""
    n_rb: int
    iters: int
    budget: int
    tiles_per_row_block: int
    k: int          # the pass and row block the launch resumes at
    r: int
    done: bool

    @property
    def run_blocks(self) -> int:
        return min(self.budget, self.n_rb)

    @property
    def grid(self) -> int:
        return self.run_blocks * self.tiles_per_row_block

    @property
    def max_chunks(self) -> int:
        # every chunk but the last runs at least one row block
        return self.iters * self.n_rb + 2

    def _chunk(self, k: int, r: int):
        """The runs of the chunk from pass ``k`` row block ``r`` (the
        control of csrc/blur.cu's chunk_control) and where it leaves."""
        runs, b = [], self.budget
        while k < self.iters and b > 0:
            n = min(b, self.n_rb - r)
            b -= n + 1               # the row units, then the pass's unit
            if r + n < self.n_rb:    # cut by the budget
                runs.append(Run(k, r, n, False))
                return tuple(runs), k, r + n
            runs.append(Run(k, r, n, True))
            k, r = k + 1, 0
        return tuple(runs), k, r

    def chunks(self) -> Iterator[tuple]:
        """Each chunk's runs, the launch's first chunk first, to the end."""
        if self.done:
            return
        k, r = self.k, self.r
        while True:
            runs, k, r = self._chunk(k, r)
            yield runs
            if k >= self.iters:
                return

    def totals(self, n_chunks: int) -> tuple:
        """(row blocks, grid-wide waits) of the launch's first
        ``n_chunks`` chunks, the chunks inside a pass jumped in one step."""
        if self.done:
            return 0, 0
        rows = waits = 0
        k, r, first_run, left = self.k, self.r, True, n_chunks
        while left > 0 and k < self.iters:
            q = min((self.n_rb - 1 - r) // self.budget, left)
            if q:  # chunks of one run each that stay inside the pass
                waits += r == 0 and not first_run
                rows, r, left, first_run = (
                    rows + q * self.budget, r + q * self.budget, left - q,
                    False)
                continue
            runs, k, r = self._chunk(k, r)
            for run in runs:
                waits += run.first == 0 and not first_run
                rows += run.n_blocks
                first_run = False
            left -= 1
        return rows, waits


def mega_plan(h: int, w: int, iters: int, budget: int, ctx_words) -> MegaPlan:
    """M1's plan for a launch over ``[H+2, W+2]`` images from the context
    ``ctx_words`` (``CTX_WORDS`` int32) at ``budget`` row blocks a chunk."""
    words = np.asarray(ctx_words)
    var, saved = words[0:8], words[24:32]
    resume = (lambda slot: int(var[slot]) if saved[slot] == 1 else 0)
    return MegaPlan(n_rb=h // ROW_BLOCK, iters=int(iters), budget=int(budget),
                    tiles_per_row_block=tiles_per_row_block(w),
                    k=resume(SLOT_K), r=resume(SLOT_ROW),
                    done=bool(words[4 * 8 + 1]))


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
    first ``result()`` checks the device's report against ``plan`` (no
    chunk cap hit; the row blocks its control issued and the grid-wide
    waits it took are the plan's for that many chunks; the tiles the blocks
    ran add up to those row blocks), adds the row blocks to ``ROW_BLOCKS``
    and keeps ``interval``, the %globaltimer nanoseconds of the first
    block's start and the last block's end.  ``grid`` holds the launch's
    blocks (the watcher included), their cap and the blocks the card holds
    at once (``csrc/blur.cu``, ``mega_grid``)."""

    def __init__(self, out: torch.Tensor, event, kind: str, plan: MegaPlan,
                 grid: dict, flag):
        self._out, self._event, self._kind, self.plan = out, event, kind, plan
        self.grid = grid
        self._flag = flag  # the kernel reads it until the event
        self._res: Optional[tuple] = None
        self.interval: Optional[tuple] = None
        self.waits: Optional[int] = None

    def query(self) -> bool:
        return self._event.query()

    def result(self):
        if self._res is None:
            self._event.synchronize()
            w = self._out.cpu().numpy()
            n = int(w[OUT_CHUNKS])
            if w[OUT_STATUS] != 0:
                raise RuntimeError(f"blur_mega ran {n} chunks without "
                                   f"finishing the task: its control flow "
                                   f"is broken")
            blocks, tiles = int(w[OUT_ROW_BLOCKS]), int(w[OUT_TILES])
            self.waits = int(w[OUT_WAITS])
            per = self.plan.tiles_per_row_block
            if (blocks, self.waits) != self.plan.totals(n) \
                    or tiles != blocks * per:
                raise RuntimeError(
                    f"blur_mega ran {n} chunks: {blocks} row blocks, "
                    f"{self.waits} grid-wide waits, {tiles} tiles ({per} a "
                    f"row block); its plan says (row blocks, waits) "
                    f"{self.plan.totals(n)}")
            stamps = w[OUT_START:OUT_END + 2].view(np.uint64)
            self.interval = (int(~stamps[0]), int(stamps[1]))
            ROW_BLOCKS.inc(self._kind, blocks)
            self._res = (w[:CTX_WORDS].copy(), n)
        return self._res


def _images(ping: torch.Tensor, pong: torch.Tensor):
    """Checks M1's ping/pong pair; returns (H, W, vec)."""
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
    vec = int(all(t.data_ptr() % 8 == 0 for t in (ping, pong))
              and ping.stride(0) % 2 == 0)
    return h, width, vec


def _grid(info) -> dict:
    return {"grid": info[0], "cap": info[1], "coresident": info[2]}


def blur_mega(ctx_words, ping: torch.Tensor, pong: torch.Tensor, kind: str,
              iters: int, budget: int, flag) -> MegaLaunch:
    """Launch M1 on the current stream: the blur task's chunk loop over
    the padded ping/pong images (``[H+2, W+2]``, H a multiple of 32), from
    the context ``ctx_words`` (``CTX_WORDS`` int32) with chunks of
    ``budget`` row-block units, until done or the first boundary ``k >=
    flag`` (``flag``: a ``PreemptFlag`` on the card).  Returns at once."""
    if kind not in KINDS:
        raise ValueError(f"unknown blur kind {kind!r}; known: {sorted(KINDS)}")
    h, width, vec = _images(ping, pong)
    if budget < 1 or iters < 0:
        raise ValueError(f"budget {budget} < 1 or iters {iters} < 0")
    words = np.ascontiguousarray(ctx_words, np.int32)
    if words.shape != (CTX_WORDS,):
        raise ValueError(f"context words {words.shape}, expected "
                         f"({CTX_WORDS},)")
    if not getattr(flag, "device_ptr", 0):
        raise ValueError("flag must be a PreemptFlag made for a CUDA device")
    plan = mega_plan(h, width, iters, budget, words)
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=ping.device)
    info = (ctypes.c_int * 3)()
    stream = torch.cuda.current_stream(ping.device)
    flag.set_progress(0)
    err = _mega_lib()(words.ctypes.data, ping.data_ptr(), pong.data_ptr(),
                      ping.stride(0), plan.n_rb, width, int(iters),
                      int(budget), plan.max_chunks, plan.grid, KINDS[kind],
                      vec, flag.device_ptr, flag.progress_ptr,
                      out.data_ptr(), ping.device.index or 0, info,
                      stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"blur_mega launch failed: CUDA error {err}")
    MEGA_LAUNCHES.inc(kind)
    event = torch.cuda.Event()
    event.record(stream)
    return MegaLaunch(out, event, kind, plan, _grid(info), flag)


# csrc/blur.cu's blur_latency_probe: the parts it times, in out[] order
PROBE_PARTS = ("run", "grid_sync", "parent_boundary", "flag_relaxed",
               "handoff_round")


def latency_probe(ping: torch.Tensor, pong: torch.Tensor, kind: str,
                  budget: int, flag, reps: int = 256) -> dict:
    """Time, on the card, the parts an M1 chunk is made of at M1's own
    geometry for ``budget`` (``blur_latency_probe``; ``PROBE_PARTS`` in
    its comment): microseconds a repetition under each name, and the
    grid.  ``ping`` is read and ``pong`` written (``budget`` must divide
    the row blocks); ``flag`` is a ``PreemptFlag`` on the card, read (0: no
    exit asked) and its progress word written.  Not a launch of any path:
    no counter moves."""
    if kind not in KINDS:
        raise ValueError(f"unknown blur kind {kind!r}; known: {sorted(KINDS)}")
    h, width, vec = _images(ping, pong)
    if not getattr(flag, "device_ptr", 0):
        raise ValueError("flag must be a PreemptFlag made for a CUDA device")
    plan = mega_plan(h, width, 1, budget, np.zeros(CTX_WORDS, np.int32))
    if plan.n_rb % plan.run_blocks or reps < 1 or not vec:
        raise ValueError(f"budget {budget} does not divide the "
                         f"{plan.n_rb} row blocks, reps {reps} < 1, or the "
                         f"images take no 8-byte loads")
    scratch = torch.zeros(64, dtype=torch.int32, device=ping.device)
    out = torch.zeros(len(PROBE_PARTS), dtype=torch.int64, device=ping.device)
    info = (ctypes.c_int * 3)()
    err = _probe_lib()(ping.data_ptr(), pong.data_ptr(), ping.stride(0),
                       plan.n_rb, width, plan.run_blocks, plan.grid,
                       KINDS[kind], vec, reps, flag.device_ptr,
                       flag.progress_ptr, scratch.data_ptr(), out.data_ptr(),
                       ping.device.index or 0, info,
                       torch.cuda.current_stream(ping.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blur_latency_probe failed: CUDA error {err}")
    ns = out.cpu().tolist()
    res = {k: ns[i] / reps / 1e3 for i, k in enumerate(PROBE_PARTS)}
    res["grid"] = _grid(info)
    return res
