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
row block = one kernel launch.  The parity of ``k`` is read from the host
context, so each row block is ONE launch that writes its 32 rows in place
into the destination image (the reference instead rebuilds both whole
images with ``jnp.where`` on every row block).
"""
from __future__ import annotations

import numpy as np

from repro_torch.controller.kernels import ctrl_kernel
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import for_save
from repro_torch.kernels.blur.ops import blur_rows

ROW_BLOCK = 32
SLOT_K, SLOT_ROW = 0, 1


def _blur_task(ctx: ContextRecord, bufs, ints, floats, kind: str):
    ping, pong = bufs[0], bufs[1]
    n_rb = (ping.shape[0] - 2) // ROW_BLOCK
    iters = int(ints[2])

    def body_row(ctx, r, state):
        even = int(ctx.var[SLOT_K]) % 2 == 0
        src, dst = (ping, pong) if even else (pong, ping)
        blur_rows(src, dst, ROW_BLOCK, r, kind)
        ctx = ctx.checkpoint(SLOT_ROW, r + 1)  # paper: checkpoint(row);
        return ctx, state

    def body_k(ctx, k, state):
        # row loop nested under the iteration loop (Listing 1.1 structure)
        ctx = ctx.checkpoint(SLOT_K, k)  # current iteration (re-entrant)
        ctx, state = for_save(ctx, SLOT_ROW, 0, n_rb, 1, body_row, state)
        # advance k iff the row loop fully completed (paper: checkpoint(k);)
        if ctx.intr == 0:
            ctx = ctx.checkpoint(SLOT_K, k + 1)
        return ctx, state

    ctx, state = for_save(ctx, SLOT_K, 0, iters, 1, body_k, None)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, tuple(bufs)


@ctrl_kernel("MedianBlur", backend="PYNQ",
             ktile_args=("input_array", "output_array"),
             int_args=("H", "W", "iters"), default_budget=8, library="blur")
def median_blur_task(ctx, bufs, ints, floats):
    return _blur_task(ctx, bufs, ints, floats, "median")


@ctrl_kernel("GaussianBlur", backend="PYNQ",
             ktile_args=("input_array", "output_array"),
             int_args=("H", "W", "iters"), default_budget=8, library="blur")
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
