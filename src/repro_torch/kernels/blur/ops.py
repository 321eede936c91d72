"""Device dispatch for the blur kernels: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``; for ``blur_mega``, the host chunk loop).
There is no fallback between the two."""
from __future__ import annotations

import torch

from repro_torch.kernels.blur import kernel as K
from repro_torch.kernels.blur import ref as R


def blur_block(block: torch.Tensor, kind: str = "median") -> torch.Tensor:
    """block: padded [RB+2, W+2] -> blurred interior [RB, W]."""
    if block.is_cuda:
        return K.blur_block(block, kind)
    return R.blur_block(block, kind)


def blur_rows(src_padded: torch.Tensor, dst_padded: torch.Tensor,
              row_block: int, r: int, kind: str, n_blocks: int = 1):
    """Blur the ``n_blocks`` row blocks from block ``r`` on (rows
    [r*RB, (r+n_blocks)*RB)) of the padded image ``src_padded`` into the
    same rows of ``dst_padded`` (in place, interior columns only): one
    launch on the card."""
    row0 = r * row_block
    if src_padded.is_cuda:
        K.blur_rows(src_padded, dst_padded, row0, row_block, kind, n_blocks)
        return
    rows = n_blocks * row_block
    w = src_padded.shape[1] - 2
    dst_padded[row0 + 1:row0 + rows + 1, 1:w + 1] = R.blur_block(
        src_padded[row0:row0 + rows + 2], kind)


def blur_mega(ctx_words, ping: torch.Tensor, pong: torch.Tensor, kind: str,
              iters: int, budget: int, flag):
    """The blur task's whole chunk loop from ``ctx_words`` over the padded
    ping/pong images, until done or the first chunk boundary ``k >= flag``
    (a ``PreemptFlag``).  On the card: one launch of the persistent kernel
    M1, returned at once.  On the CPU: its plain version, the host loop of
    ``core/preemption.make_megakernel`` over the blur task, finished before
    it returns.  Either way the result is a launch with ``query()`` and
    ``result() -> (context words, n_chunks)``."""
    if ping.is_cuda:
        return K.blur_mega(ctx_words, ping, pong, kind, iters, budget, flag)
    # the task layer imports this module: bind it at call time
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import MegaDone, make_megakernel
    from repro_torch.kernels.blur.tasks import KERNELS, task_ints

    launch = make_megakernel(get_kernel(KERNELS[kind]))(
        ContextRecord.from_words(ctx_words), (ping, pong),
        task_ints(ping.shape[0] - 2, ping.shape[1] - 2, iters), None,
        budget, flag)
    ctx, _, n_chunks = launch.result()
    return MegaDone(ctx.to_words(), n_chunks)
