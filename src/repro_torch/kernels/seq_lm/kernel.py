"""The persistent surrogate-LM serving kernels (``csrc/seq_lm.cu``) bound
to PyTorch: M2, ``seq_prefill_mega``, and M3, ``seq_decode_mega``.

Counterparts of the reference's ``make_megakernel`` over ``seq_prefill``
and ``seq_decode`` (``repro/core/preemption.py``,
``repro/serving/kernels.py``): one launch runs a serving task's remaining
chunk loop on the card, a watcher warp reading the region's mapped preempt
flag one chunk ahead of the boundary it decides; ``plan`` gives the block's
geometry and whether the state rows stay in shared memory for the launch.
This module checks device, dtype, shapes and strides,
launches on the current stream, raises if the launch was refused, and
counts launches per kernel in ``MEGA_LAUNCHES``; the surrogate steps the
device reports it ran go to ``STEPS`` when the launch's result is read.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.context import CTX_WORDS
from repro_torch.kernels.native import (LaunchCounter, check_tensor,
                                        load_library)

MEGA_LAUNCHES = LaunchCounter()
STEPS = LaunchCounter()
# words[] layout of csrc/seq_lm.cu: the context words, then these
OUT_CHUNKS, OUT_STEPS, OUT_STATUS = CTX_WORDS, CTX_WORDS + 1, CTX_WORDS + 2
OUT_WORDS = CTX_WORDS + 3
SLOTS_W = 8          # the slots table's width (serving/engine.py SLOTS_W)
MAX_SLOTS = 128      # 26 compute warps of 5 rows and the watcher
MAX_WARPS = 32       # a block's 1024 threads
# the most state bytes a launch holds in shared memory (csrc/seq_lm.cu allows
# up to 227 KiB less 1 KiB); above it the rows stay in global memory
RESIDENT_BYTES = 224 * 1024


def _fn(name: str, argtypes):
    fn = getattr(load_library("seq_lm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PREFILL_ARGS = [_P] * 4 + [_I] * 6 + [_P] * 3 + [_I, _P]
_DECODE_ARGS = ([_P, _P, _L, _P, _L, _P, _L] + [_I] * 8 + [_P] * 3
                + [_I, _P])


def plan(s: int, d: int) -> dict:
    """The launch's geometry for ``s`` state rows of ``d`` int32 (M2: ``s``
    1): one block of ``compute_warps`` warps, each walking
    ``rows_per_warp`` rows (a row a warp up to 31 rows, else as few as
    fit in 31 warps), the lanes over ``d``, and one watcher warp that reads
    the flag (``warps`` in all); ``resident`` when the rows'
    ``smem_bytes`` fit in ``RESIDENT_BYTES`` of shared memory for the
    launch, else they stay in global memory (``smem_bytes`` 0)."""
    if not 1 <= s <= MAX_SLOTS or d < 1:
        raise ValueError(f"S {s} (at most {MAX_SLOTS}), D {d}")
    rows_per_warp = -(-s // (MAX_WARPS - 1))
    compute = -(-s // rows_per_warp)
    resident = s * d * 4 <= RESIDENT_BYTES
    return {"warps": compute + 1, "compute_warps": compute,
            "rows_per_warp": rows_per_warp, "resident": resident,
            "smem_bytes": s * d * 4 if resident else 0}


class MegaLaunch:
    """One persistent launch in flight: ``query()`` polls the event
    recorded after it; ``result()`` waits for it, reads the words the
    kernel wrote back and returns ``(context words, n_chunks)``.  The first
    ``result()`` checks that the launch did not hit its chunk cap and adds
    the steps it ran to ``steps`` (a ``LaunchCounter``, ``STEPS`` for
    M2/M3)."""

    def __init__(self, name: str, words: torch.Tensor, event, flag, bufs,
                 steps: LaunchCounter = STEPS):
        self._name, self._words, self._event = name, words, event
        # the kernel reads the flag and the buffers until the event
        self._flag, self._bufs = flag, bufs
        self._steps = steps
        self._res: Optional[tuple] = None

    def query(self) -> bool:
        return self._event.query()

    def result(self):
        if self._res is None:
            self._event.synchronize()
            w = self._words.cpu().numpy()
            if w[OUT_STATUS] != 0:
                raise RuntimeError(f"{self._name} ran {w[OUT_CHUNKS]} chunks "
                                   f"without finishing the task: its "
                                   f"control flow is broken")
            self._steps.inc(self._name, int(w[OUT_STEPS]))
            self._res = (w[:CTX_WORDS].copy(), int(w[OUT_CHUNKS]))
        return self._res


def persistent_words(ctx_words, budget: int, flag):
    """The context words as the C entries take them; raises on a bad
    budget or a flag that is not on a CUDA device."""
    words = np.ascontiguousarray(ctx_words, np.int32)
    if words.shape != (CTX_WORDS,):
        raise ValueError(f"context words {words.shape}, expected "
                         f"({CTX_WORDS},)")
    if budget < 1:
        raise ValueError(f"budget {budget} < 1")
    if not getattr(flag, "device_ptr", 0):
        raise ValueError("flag must be a PreemptFlag made for a CUDA device")
    return words


def launch_persistent(name, fn, args, bufs, flag,
                      launches: LaunchCounter = MEGA_LAUNCHES,
                      steps: LaunchCounter = STEPS) -> MegaLaunch:
    """Call the C entry ``fn(*args, flag, progress, words, device,
    stream)`` on the current stream of ``bufs[0]``'s device, raise if it
    refused, count the launch in ``launches`` under ``name`` and return
    the launch; ``bufs`` stay referenced until it is read."""
    device = bufs[0].device
    # thread 0 writes every word at the launch's end: no zeroing
    out = torch.empty(OUT_WORDS, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    flag.set_progress(0)
    err = fn(*args, flag.device_ptr, flag.progress_ptr, out.data_ptr(),
             device.index or 0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches.inc(name)
    event = torch.cuda.Event()
    event.record(stream)
    return MegaLaunch(name, out, event, flag, bufs, steps)


def seq_prefill_mega(ctx_words, out: torch.Tensor, state: torch.Tensor,
                     prompt: torch.Tensor, prompt_len: int, vocab: int,
                     budget: int, flag) -> MegaLaunch:
    """Launch M2 on the current stream: fold ``prompt[0, :prompt_len]``
    into ``state`` (i32[1, D]) from the context ``ctx_words``, a position
    per budget unit, chunks of ``budget``, until done (the first token in
    ``out[0, 0]``, out i32[1, W]) or the first boundary ``k >= flag``.
    Returns at once."""
    words = persistent_words(ctx_words, budget, flag)
    device = state.device
    d = state.shape[-1] if state.dim() == 2 else 0
    p = prompt.shape[-1] if prompt.dim() == 2 else 0
    check_tensor(state, "state", (1, d), device, torch.int32)
    check_tensor(prompt, "prompt", (1, p), device, torch.int32)
    check_tensor(out, "out", (1, out.shape[-1]), device, torch.int32)
    if d < 1 or not 0 <= prompt_len <= p or vocab < 1:
        raise ValueError(f"D {d}, prompt_len {prompt_len} of {p}, vocab "
                         f"{vocab}")
    fn = _fn("seq_prefill_mega", _PREFILL_ARGS)
    # every chunk but the last folds at least one position
    max_chunks = prompt_len + 2
    return launch_persistent(
        "SeqPrefill", fn,
        (words.ctypes.data, out.data_ptr(), state.data_ptr(),
         prompt.data_ptr(), d, int(prompt_len), int(vocab), int(budget),
         max_chunks, int(plan(1, d)["resident"])), (out, state, prompt), flag)


def seq_decode_mega(ctx_words, out: torch.Tensor, state: torch.Tensor,
                    slots: torch.Tensor, vocab: int, budget: int,
                    flag) -> MegaLaunch:
    """Launch M3 on the current stream: the decode round's R steps over
    the S slot rows (out i32[S, R], state i32[S, D], slots i32[S, 8]) from
    the context ``ctx_words``, a step per budget unit, chunks of
    ``budget``, until done or the first boundary ``k >= flag``.  Returns at
    once."""
    words = persistent_words(ctx_words, budget, flag)
    device = state.device
    if state.dim() != 2 or out.dim() != 2:
        raise ValueError(f"state {tuple(state.shape)} and out "
                         f"{tuple(out.shape)} must be 2-D")
    (s, d), r = state.shape, out.shape[1]
    check_tensor(state, "state", (s, d), device, torch.int32)
    check_tensor(out, "out", (s, r), device, torch.int32)
    check_tensor(slots, "slots", (s, SLOTS_W), device, torch.int32)
    if not 1 <= s <= MAX_SLOTS or d < 1 or vocab < 1:
        raise ValueError(f"S {s} (at most {MAX_SLOTS}), D {d}, vocab {vocab}")
    fn = _fn("seq_decode_mega", _DECODE_ARGS)
    geo = plan(s, d)
    max_chunks = r + 2
    return launch_persistent(
        "SeqDecode", fn,
        (words.ctypes.data, out.data_ptr(), out.stride(0), state.data_ptr(),
         state.stride(0), slots.data_ptr(), slots.stride(0), s, d, r,
         int(vocab), int(budget), max_chunks, geo["rows_per_warp"],
         int(geo["resident"])), (out, state, slots), flag)


# csrc/seq_lm.cu's seq_latency_probe: the steps it times, in out[] order
# ("parent_": the chunk of the earlier design, whose boundary read the flag
# with ld.acquire.sys and whose steps kept the state in global memory)
PROBE_STEPS = ("imad", "iadd", "shfl_add", "bar_sync", "flag_read",
               "boundary", "m2_step", "m3_step", "token_of",
               "parent_control", "prompt_load", "parent_chunk_noflag",
               "parent_chunk", "control", "m2_step_resident", "flag_relaxed",
               "flag_overlap", "fence_sys", "device_read", "bar_after_read",
               "m3_chunk_under_read")
PROBE_WORDS = len(PROBE_STEPS) + 3


def latency_probe(flag, d: int, vocab: int, warps: int,
                  reps: int = 1024) -> dict:
    """Time, on the card, the dependent steps an M2/M3 chunk is made of
    (``seq_latency_probe``: one block of ``warps`` warps, clock64 stamps
    around ``reps`` repetitions of each): cycles a repetition under each
    name of ``PROBE_STEPS``, and ``ns_per_cycle``, the probe's globaltimer
    nanoseconds over its clock64 cycles.  ``flag`` is a ``PreemptFlag``
    made for a CUDA device; the probe reads its word (0: no exit asked)
    and writes its progress word.  Not a launch of the serving path: no
    counter moves."""
    if not getattr(flag, "device_ptr", 0):
        raise ValueError("flag must be a PreemptFlag made for a CUDA device")
    # a row of d ints a warp in shared memory
    if not 1 <= warps <= MAX_WARPS or d < 1 or warps * d * 4 > RESIDENT_BYTES \
            or vocab < 1 or reps < 1:
        raise ValueError(f"warps {warps}, D {d}, vocab {vocab}, reps {reps}")
    device = torch.device("cuda", torch.cuda.current_device())
    row = torch.zeros(d, dtype=torch.int32, device=device)
    out = torch.zeros(PROBE_WORDS, dtype=torch.int64, device=device)
    fn = _fn("seq_latency_probe", [_P] * 4 + [_I] * 5 + [_P])
    err = fn(flag.device_ptr, flag.progress_ptr, row.data_ptr(),
             out.data_ptr(), d, vocab, warps, reps, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seq_latency_probe failed: CUDA error {err}")
    w = out.cpu().tolist()
    n = len(PROBE_STEPS)
    res = {k: w[i] / reps for i, k in enumerate(PROBE_STEPS)}
    res["ns_per_cycle"] = w[n + 1] / w[n]
    return res
