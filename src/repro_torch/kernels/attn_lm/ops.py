"""Device dispatch for the persistent attention-LM kernels M4/M5: CUDA
tensors go to the hand-written kernels (``kernel.py``) or raise; CPU
tensors take the plain version, the host loop of
``core/preemption.make_megakernel`` over the task's chunk body
(``serving/attention.py``), with the same stop rule.  There is no fallback
between the two; only an explicit ``plain_versions()`` block runs the
plain version on the card.  Either way the result is a launch with
``query()`` and ``result() -> (context words, n_chunks)``."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.attn_lm import kernel as K
from repro_torch.kernels.native import plain_versions, use_kernel  # noqa: F401
from repro_torch.kernels.seq_lm.ops import host_loop


def attn_prefill_mega(kernel: str, ctx_words, bufs, g: K.Geometry,
                      budget: int, flag):
    """AttnPrefill's chunk loop (``kernel``: its registered name) from
    ``ctx_words`` over ``bufs`` = (out, k_new, v_new, prompt, meta,
    weights), in place, until done or the first chunk boundary ``k >=
    flag`` (a ``PreemptFlag``).  On the card: one launch of M4, returned at
    once; on the CPU: the plain version, finished before it returns."""
    out, k_new, v_new, prompt, meta, weights = bufs[:6]
    if use_kernel(out):
        return K.attn_prefill_mega(ctx_words, out, k_new, v_new, prompt, meta,
                                   weights, g, budget, flag)
    ints = np.array([prompt.shape[0], prompt.shape[1], g.vocab], np.int32)
    return host_loop(kernel, ctx_words, tuple(bufs[:6]), ints, budget, flag)


def attn_decode_mega(kernel: str, ctx_words, bufs, g: K.Geometry,
                     budget: int, flag):
    """AttnDecode's chunk loop (``kernel``: its registered name) from
    ``ctx_words`` over ``bufs`` = (out, k_pool, v_pool, table, weights), in
    place, until done or the first chunk boundary ``k >= flag``.  On the
    card: one launch of M5, returned at once; on the CPU: the plain
    version, finished before it returns."""
    out, k_pool, v_pool, table, weights = bufs[:5]
    if use_kernel(out):
        return K.attn_decode_mega(ctx_words, out, k_pool, v_pool, table,
                                  weights, g, budget, flag)
    ints = np.array([out.shape[0], out.shape[1], g.vocab], np.int32)
    return host_loop(kernel, ctx_words, tuple(bufs[:5]), ints, budget, flag)
