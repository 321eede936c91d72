"""Prefill / decode region kernels for the token-serving engine — the
port of ``repro/serving/kernels.py``.  Two distinct bitstream kinds, as the
paper's tasks are distinct partial bitstreams: a region reconfigures to
move between the prefill and the decode phase.

The model is the reference's **deterministic integer surrogate LM**: all
arithmetic wraps in int32 and every update is row-independent, so a token
stream is bit-identical under any batch composition, chunk boundary,
preemption or region:

    state' = state * MIX_A + tok * (2*pos + 1) + pos * PHI + MIX_C
    token  = ((sum(state') * MIX_A + MIX_C) & 0x7fffffff) % vocab

``torch.sum`` promotes int32 to int64 unless told otherwise, so the readout
sums with ``dtype=torch.int32`` to keep the reference's wrap.  Loop control
stays on the host, as in the blur tasks: the reference's ``jnp.where``
merges on ``finished`` become plain conditionals, and each step writes its
slot of the result buffers in place.  Both kernels keep their results on
the card (``device_result=True``): the engine threads a round's state
straight into the next round's bundle.

Both register a persistent entry (``mega``): in megakernel mode a task's
chunk loop is one launch of M2 (``SeqPrefill``) or M3 (``SeqDecode``) on
the card (``csrc/seq_lm.cu``, ``kernels/seq_lm``), the same control flow
and the same wrapping arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.controller.kernels import ctrl_kernel
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import for_save
from repro_torch.kernels.seq_lm.ops import seq_decode_mega, seq_prefill_mega

# LCG-style mixing constants (wrapping int32 throughout).  PHI is the
# signed-int32 bit pattern of 2654435761 (Knuth's multiplicative hash).
MIX_A = 1103515245
MIX_C = 12345
PHI = -1640531535

SLOT_POS = 0            # the single checkpoint slot both kernels use
# slots-table columns (SeqDecode bufs[2], i32[S, 8])
COL_ACTIVE, COL_N_EMIT, COL_LAST_TOK = 0, 1, 2


# -- surrogate LM (torch: runs on the buffers' device) ---------------------

def lm_step(state: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One token of context folded into the hidden state.
    state: i32[S, D]; tok: i32[S] -> i32[S, D].  Row-independent."""
    pos = torch.arange(state.shape[-1], dtype=torch.int32,
                       device=state.device)
    inj = tok[:, None] * (2 * pos + 1)[None, :] + pos[None, :] * PHI
    return state * MIX_A + inj + MIX_C


def lm_token(state: torch.Tensor, vocab: int) -> torch.Tensor:
    """Greedy token readout.  state: i32[S, D] -> i32[S]."""
    h = torch.sum(state, dim=-1, dtype=torch.int32) * MIX_A + MIX_C
    return (h & 0x7FFFFFFF) % vocab


# -- host-side twins (numpy, wrapping int32) -------------------------------

def init_state(seed: int, d_model: int) -> np.ndarray:
    """Deterministic initial hidden state for one sequence, i32[D]."""
    with np.errstate(over="ignore"):
        pos = np.arange(d_model, dtype=np.int32)
        return (np.int32(seed + 1) * np.int32(MIX_A)
                + pos * np.int32(PHI) + np.int32(MIX_C)).astype(np.int32)


def _np_step(state: np.ndarray, tok: int) -> np.ndarray:
    pos = np.arange(state.shape[-1], dtype=np.int32)
    inj = np.int32(tok) * (2 * pos + 1) + pos * np.int32(PHI)
    return (state * np.int32(MIX_A) + inj + np.int32(MIX_C)).astype(np.int32)


def _np_token(state: np.ndarray, vocab: int) -> int:
    h = state.sum(dtype=np.int32) * np.int32(MIX_A) + np.int32(MIX_C)
    return int((int(h) & 0x7FFFFFFF) % vocab)


def oracle_stream(prompt, seed: int, max_new_tokens: int,
                  d_model: int, vocab: int) -> list:
    """Pure-NumPy reference for one uninterrupted sequence: the exact
    token stream the kernels must produce under ANY batching, chunking,
    preemption, or migration schedule."""
    with np.errstate(over="ignore"):
        state = init_state(seed, d_model)
        for t in prompt:
            state = _np_step(state, int(t))
        toks = [_np_token(state, vocab)]
        while len(toks) < max_new_tokens:
            state = _np_step(state, toks[-1])
            toks.append(_np_token(state, vocab))
        return toks


# -- region kernels ----------------------------------------------------------

def _prefill_persistent(ctx_words, bufs, ints, floats, budget, flag):
    """The megakernel engine's entry for ``SeqPrefill``: M2."""
    return seq_prefill_mega(ctx_words, bufs[0], bufs[1], bufs[2],
                            int(ints[3]), int(ints[2]), budget, flag)


def _decode_persistent(ctx_words, bufs, ints, floats, budget, flag):
    """The megakernel engine's entry for ``SeqDecode``: M3."""
    return seq_decode_mega(ctx_words, bufs[0], bufs[1], bufs[2],
                           int(ints[3]), budget, flag)


@ctrl_kernel("SeqPrefill", backend="PYNQ",
             ktile_args=("out", "state", "prompt"),
             int_args=("P", "D", "vocab", "prompt_len"),
             default_budget=8, device_result=True,
             mega=_prefill_persistent, mega_library="seq_lm")
def seq_prefill(ctx: ContextRecord, bufs, ints, floats):
    """Fold ``prompt[0, :prompt_len]`` into ``state`` (i32[1, D]) one
    position per budget unit; on completion emit the first generated
    token into ``out[0, 0]``.  bufs: (out i32[1, 8], state i32[1, D],
    prompt i32[1, P])."""
    out, state, prompt = bufs[0], bufs[1], bufs[2]
    vocab, prompt_len = int(ints[2]), int(ints[3])

    def body_pos(ctx, i, st):
        st.copy_(lm_step(st, prompt[:, i]))
        return ctx.checkpoint(SLOT_POS, i + 1), st

    ctx, state = for_save(ctx, SLOT_POS, 0, prompt_len, 1, body_pos, state)
    if ctx.intr == 0:
        out[0, 0] = lm_token(state, vocab)[0]
        ctx = ctx.finish()
    return ctx, (out, state, prompt) + tuple(bufs[3:])


@ctrl_kernel("SeqDecode", backend="PYNQ",
             ktile_args=("out", "state", "slots"),
             int_args=("S", "D", "R", "vocab"),
             default_budget=4, device_result=True,
             mega=_decode_persistent, mega_library="seq_lm")
def seq_decode(ctx: ContextRecord, bufs, ints, floats):
    """One decode *round*: advance every active slot by one token per
    step, R steps.  bufs: (out i32[S, R], state i32[S, D],
    slots i32[S, 8]) with slots columns (active, n_emit, last_token).
    A slot participates in step t iff active and t < n_emit; inactive
    rows pass through untouched, so batch composition never perturbs a
    resident sequence's stream."""
    out, state, slots = bufs[0], bufs[1], bufs[2]
    R = out.shape[1]
    vocab = int(ints[3])

    def body_t(ctx, t, st):
        live = (slots[:, COL_ACTIVE] == 1) & (t < slots[:, COL_N_EMIT])
        st2 = lm_step(state, slots[:, COL_LAST_TOK])
        tok2 = lm_token(st2, vocab)
        state.copy_(torch.where(live[:, None], st2, state))
        out[:, t] = torch.where(live, tok2, out[:, t])
        slots[:, COL_LAST_TOK] = torch.where(live, tok2,
                                             slots[:, COL_LAST_TOK])
        return ctx.checkpoint(SLOT_POS, t + 1), st

    ctx, _ = for_save(ctx, SLOT_POS, 0, R, 1, body_t, None)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, (out, state, slots) + tuple(bufs[3:])
