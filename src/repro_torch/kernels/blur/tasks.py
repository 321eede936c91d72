"""The paper's task set (§6.1) as preemptible Controller kernels:
Median Blur over 1/2/3 iterations and Gaussian Blur over 1 iteration,
written with the ``for_save`` / ``checkpoint`` abstractions of §5.2.

State layout (ArgBundle buffer slots):
    bufs[0] = ping image, padded [H+2, W+2] f32 (zero ring)
    bufs[1] = pong image, same shape
Iteration k reads ping when k is even and writes pong (and vice versa), so
partial progress always lives in the buffers — checkpoint/resume needs no
extra copies.  Context slots: 0 = iteration k, 1 = row block index.  The
checkpoint convention stores the NEXT index (exactly-once row blocks).

The row-block loop is the preemption granularity: one ``budget`` unit = one
row block, exactly as in the reference.  The launches are coarser: the
row blocks of one pass that a chunk covers are consecutive and independent
(they read one image and write the other), so ``body_row`` only records
its block and the run goes to the card as ONE launch when the pass's row
loop returns -- complete, or cut by the budget, which is also where the
chunk ends.  A run never spans two passes (the next pass reads what this
one wrote).  A chunk spends budget on the iteration loop too, so it
touches at most two passes: at most two launches a chunk.  The parity of
``k`` is read from the host context and each run writes its rows in place
into the destination image (the reference instead rebuilds both whole
images with ``jnp.where`` on every row block).

Both kernels register a persistent entry (``mega``): in megakernel mode a
CUDA region runs the whole chunk loop below as one launch of M1
(``csrc/blur.cu``, ``ops.blur_mega``), the same control flow on the card.
"""
from __future__ import annotations

import numpy as np

from repro_torch.controller.kernels import ctrl_kernel
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import for_save
from repro_torch.controller.abi import N_INT_ARGS
from repro_torch.kernels.blur.ops import blur_mega, blur_rows

ROW_BLOCK = 32
SLOT_K, SLOT_ROW = 0, 1
KERNELS = {"median": "MedianBlur", "gaussian": "GaussianBlur"}


class _Run:
    """The pending run of consecutive row blocks of one pass."""

    def __init__(self, kind: str):
        self.kind, self.src, self.dst, self.first, self.count = (
            kind, None, None, 0, 0)

    def add(self, src, dst, r: int):
        if self.count and src is self.src and r == self.first + self.count:
            self.count += 1
            return
        self.flush()
        self.src, self.dst, self.first, self.count = src, dst, r, 1

    def flush(self):
        if self.count:
            blur_rows(self.src, self.dst, ROW_BLOCK, self.first, self.kind,
                      self.count)
            self.count = 0


def _blur_task(ctx: ContextRecord, bufs, ints, floats, kind: str):
    ping, pong = bufs[0], bufs[1]
    n_rb = (ping.shape[0] - 2) // ROW_BLOCK
    iters = int(ints[2])
    run = _Run(kind)

    def body_row(ctx, r, state):
        even = int(ctx.var[SLOT_K]) % 2 == 0
        src, dst = (ping, pong) if even else (pong, ping)
        run.add(src, dst, r)
        ctx = ctx.checkpoint(SLOT_ROW, r + 1)  # paper: checkpoint(row);
        return ctx, state

    def body_k(ctx, k, state):
        # row loop nested under the iteration loop (Listing 1.1 structure)
        ctx = ctx.checkpoint(SLOT_K, k)  # current iteration (re-entrant)
        ctx, state = for_save(ctx, SLOT_ROW, 0, n_rb, 1, body_row, state)
        run.flush()  # complete or cut by the budget: launch the pass's run
        # advance k iff the row loop fully completed (paper: checkpoint(k);)
        if ctx.intr == 0:
            ctx = ctx.checkpoint(SLOT_K, k + 1)
        return ctx, state

    ctx, state = for_save(ctx, SLOT_K, 0, iters, 1, body_k, None)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, tuple(bufs)


def task_ints(h: int, w: int, iters: int) -> np.ndarray:
    """The padded int arguments of a blur task (``H``, ``W``, ``iters``)."""
    ints = np.zeros((N_INT_ARGS,), np.int32)
    ints[:3] = (h, w, iters)
    return ints


def _persistent(kind: str):
    """The megakernel engine's entry for one body: the context words and
    the ping/pong buffers to ``ops.blur_mega``."""
    def mega(ctx_words, bufs, ints, floats, budget, flag):
        return blur_mega(ctx_words, bufs[0], bufs[1], kind, int(ints[2]),
                         budget, flag)

    return mega


@ctrl_kernel("MedianBlur", backend="PYNQ",
             ktile_args=("input_array", "output_array"),
             int_args=("H", "W", "iters"), default_budget=8, library="blur",
             mega=_persistent("median"))
def median_blur_task(ctx, bufs, ints, floats):
    return _blur_task(ctx, bufs, ints, floats, "median")


@ctrl_kernel("GaussianBlur", backend="PYNQ",
             ktile_args=("input_array", "output_array"),
             int_args=("H", "W", "iters"), default_budget=8, library="blur",
             mega=_persistent("gaussian"))
def gaussian_blur_task(ctx, bufs, ints, floats):
    return _blur_task(ctx, bufs, ints, floats, "gaussian")


def make_image(rng, size: int, pad_to: int = 128):
    """Random image padded to a 128-multiple width plus the zero halo ring
    (the reference's shapes, so ABI signatures agree)."""
    H = W = int(np.ceil(size / pad_to) * pad_to)
    img = np.zeros((H + 2, W + 2), np.float32)
    img[1:size + 1, 1:size + 1] = rng.random((size, size), dtype=np.float32)
    return img


def result_image(task, iters: int):
    """Fetch the blurred image from a finished task (ping/pong parity)."""
    ping, pong = task.result
    return pong if iters % 2 == 1 else ping
