"""Device dispatch for the persistent surrogate-LM kernels M2/M3: CUDA
tensors go to the hand-written kernels (``kernel.py``) or raise; CPU
tensors take the plain version, the host loop of
``core/preemption.make_megakernel`` over the task body
(``serving/kernels.py``), with the same stop rule.  There is no fallback
between the two; only an explicit ``plain_versions()`` block runs the
plain version on the card.  Either way the result is a launch with
``query()`` and ``result() -> (context words, n_chunks)``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.native import plain_versions, use_kernel  # noqa: F401
from repro_torch.kernels.seq_lm import kernel as K


def host_loop(kernel: str, ctx_words, bufs, ints, budget: int, flag):
    """The plain version of a persistent entry: ``make_megakernel``'s host
    loop over ``kernel``'s chunk body from ``ctx_words``, with the same
    stop rule; finished before it returns."""
    # the serving layer imports this module: bind it at call time
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import MegaDone, make_megakernel

    launch = make_megakernel(get_kernel(kernel))(
        ContextRecord.from_words(ctx_words), bufs, ints, None, budget, flag)
    ctx, _, n_chunks = launch.result()
    return MegaDone(ctx.to_words(), n_chunks)


def seq_prefill_mega(ctx_words, out: torch.Tensor, state: torch.Tensor,
                     prompt: torch.Tensor, prompt_len: int, vocab: int,
                     budget: int, flag):
    """SeqPrefill's chunk loop from ``ctx_words``: fold ``prompt[0,
    :prompt_len]`` into ``state`` [1, D] in place, the first token into
    ``out[0, 0]`` on completion, until done or the first chunk boundary
    ``k >= flag`` (a ``PreemptFlag``).  On the card: one launch of M2,
    returned at once; on the CPU: the plain version, finished before it
    returns."""
    if use_kernel(state):
        return K.seq_prefill_mega(ctx_words, out, state, prompt, prompt_len,
                                  vocab, budget, flag)
    ints = np.array([prompt.shape[-1], state.shape[-1], vocab, prompt_len],
                    np.int32)
    return host_loop("SeqPrefill", ctx_words, (out, state, prompt), ints,
                     budget, flag)


def seq_decode_mega(ctx_words, out: torch.Tensor, state: torch.Tensor,
                    slots: torch.Tensor, vocab: int, budget: int, flag):
    """SeqDecode's chunk loop from ``ctx_words``: the round's R steps over
    the S slot rows (``out`` [S, R], ``state`` [S, D], ``slots`` [S, 8],
    in place), until done or the first chunk boundary ``k >= flag``.  On
    the card: one launch of M3, returned at once; on the CPU: the plain
    version, finished before it returns."""
    if use_kernel(state):
        return K.seq_decode_mega(ctx_words, out, state, slots, vocab, budget,
                                 flag)
    ints = np.array([state.shape[0], state.shape[1], out.shape[1], vocab],
                    np.int32)
    return host_loop("SeqDecode", ctx_words, (out, state, slots), ints,
                     budget, flag)
