"""Programmer abstractions for preemption (paper §5.2): ``for_save``,
``checkpoint`` (on ContextRecord), and the chunked preemptible runner.

A preemptible kernel is written as::

    def kernel(ctx, state, ints, floats):
        def body_k(ctx, k, state):
            def body_row(ctx, row, state):
                ... launch device work ...
                ctx = ctx.checkpoint(SLOT_ROW, row)   # paper: checkpoint(row);
                return ctx, state
            ctx, state = for_save(ctx, SLOT_ROW, 0, H, 1, body_row, state)
            ctx = ctx.checkpoint(SLOT_K, k)           # paper: checkpoint(k);
            return ctx, state
        ctx, state = for_save(ctx, SLOT_K, 0, iters, 1, body_k, state)
        return ctx.finish(), state

The kernel runs in bounded *chunks*: each dispatch gets ``ctx.budget``
innermost iterations; when the budget hits 0 every enclosing ``for_save``
exits, leaving the checkpointed slots as the resume point.  Preemption and
stragglers are handled BETWEEN chunks by the region worker.

Loop control is host Python over the host-side ``ContextRecord``: the
bodies only enqueue device work (kernel launches on the current stream), so
running a chunk never waits for the GPU.

The megakernel engine (``make_megakernel``, ``PreemptFlag``) folds a
task's whole chunk loop into one launch: on the card a hand-written
persistent kernel runs the same loop nest with the context on the device
and polls a mapped host flag at every chunk boundary; on the CPU its plain
version is a host loop over the chunk entry with the same stop rule.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.context import ContextRecord


def for_save(ctx: ContextRecord, slot: int, start, stop, step,
             body: Callable, state: Any):
    """Preemptible counted loop (paper's ``for_save`` macro).

    ``body(ctx, i, state) -> (ctx, state)`` SHOULD call
    ``ctx.checkpoint(slot, i)`` (by convention at iteration end) — exactly
    like the paper, where what/when to checkpoint is the programmer's choice.
    Resumes from the checkpointed slot if set; restarts cleanly otherwise.
    """
    ctx = ctx.declare(slot, start, step)
    i = ctx.resume_value(slot, start)
    ctx = ctx.unsave(slot)
    while i < stop and ctx.budget > 0 and ctx.intr == 0:
        ctx = ctx.clear_intr()
        ctx, state = body(ctx, i, state)
        # the iteration counts iff the body fully completed — i.e. no nested
        # for_save inside it was interrupted by the budget.  An interrupted
        # iteration resumes from its own checkpoints on the next chunk.
        ok = ctx.intr == 0
        ctx = ctx.dec_budget()
        if ok:
            i += step
    # completed normally -> clear the slot so a later re-entry restarts;
    # interrupted -> keep the user's checkpoints, and tell enclosing loops.
    completed = i >= stop
    if completed:
        ctx = ctx.clear(slot)
    ctx = ctx.mark_intr(0 if completed else 1)
    return ctx, state


def make_chunk_fn(kernel_fn: Callable):
    """Wrap a preemptible kernel into the plain chunk entry point:

        chunk(ctx, state, ints, floats) -> (ctx, state)

    the region worker re-dispatches it until ``ctx.done == 1``.
    """
    def chunk(ctx: ContextRecord, state, ints, floats):
        return kernel_fn(ctx, state, ints, floats)

    return chunk


def make_pipelined_chunk(kernel_fn: Callable):
    """The uniform chunk entry point:

        chunk(ctx, state, ints, floats, budget) -> (ctx, state, done)

    - **done-gated identity** — on a finished context the chunk is an exact
      pass-through that launches nothing.  This is the speculative-discard
      rule: the one chunk the pipelined worker issues beyond completion
      computes nothing, so speculation can never change results.
    - **budget reset inside the entry** — ``ctx.with_budget(budget)``.
    - ``done`` is the host flag after this chunk; the region pairs it with
      an event recorded on its stream, which says when the chunk's device
      work has finished.
    """
    def chunk(ctx: ContextRecord, state, ints, floats, budget):
        if ctx.done == 0:
            ctx, state = kernel_fn(ctx.with_budget(budget), state, ints,
                                   floats)
        return ctx, state, ctx.done

    return chunk


class PreemptFlag:
    """The host-writable preempt flag a megakernel launch polls at every
    chunk boundary, one per region.

    Value protocol (the reference's): ``0`` = keep running; ``N >= 1`` =
    exit at the first chunk boundary ``k >= N`` (``k`` counts the chunks
    completed within the current launch).  ``Region.request_preempt``
    writes ``1``; tests and the serving probe write an exact ``N`` through
    ``Task.preempt_at_boundary``.

    On a CUDA device the word is pinned host memory mapped into the
    device's address space (``csrc/preempt_flag.cu``); the host writes it
    through a numpy view and the running kernel reads it with system-scope
    acquire loads, so a host store is seen at the next boundary with no
    copy and no launch.  On the CPU it is a plain host ``int32``.

    A second word holds the launch's progress: the chunks it has
    completed, written at every boundary before the flag is read (by the
    kernel on the card, by the host loop on the CPU).
    """

    def __init__(self, device: Optional[torch.device] = None):
        # the words as the device addresses them (CUDA): the flag, then the
        # progress
        self.device_ptr = 0
        if device is not None and torch.device(device).type == "cuda":
            from repro_torch.kernels.native import load_library

            lib = load_library("preempt_flag")
            lib.preempt_flag_alloc.argtypes = [
                ctypes.POINTER(ctypes.c_void_p)] * 2
            lib.preempt_flag_alloc.restype = ctypes.c_int
            lib.preempt_flag_free.argtypes = [ctypes.c_void_p]
            lib.preempt_flag_free.restype = ctypes.c_int
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            err = lib.preempt_flag_alloc(ctypes.byref(host),
                                         ctypes.byref(dev))
            if err != 0:
                raise RuntimeError(f"preempt_flag_alloc failed: CUDA error "
                                   f"{err}")
            self._view = np.ctypeslib.as_array(
                ctypes.cast(host, ctypes.POINTER(ctypes.c_int32)),
                shape=(2,))
            self.device_ptr = dev.value
            # freed with the flag; a region holds its flag while a launch
            # runs, so no kernel reads a freed word.  Left to the process's
            # end at exit, when a context may already be gone
            fin = weakref.finalize(self, lib.preempt_flag_free, host)
            fin.atexit = False
        else:
            self._view = np.zeros((2,), np.int32)

    def write(self, boundary: int):
        self._view[0] = boundary

    def read(self) -> int:
        return int(self._view[0])

    def clear(self):
        self._view[0] = 0

    @property
    def progress_ptr(self) -> int:
        """The progress word as the device addresses it (CUDA)."""
        return self.device_ptr + 4

    def progress(self) -> int:
        """The chunks the current (or last) launch has completed."""
        return int(self._view[1])

    def set_progress(self, chunks: int):
        self._view[1] = chunks


class MegaDone:
    """A finished megakernel launch (a plain version's, which runs on the
    host before it returns): ``result()`` returns what it was made of."""

    def __init__(self, *result):
        self._out = result

    def query(self) -> bool:
        return True

    def result(self):
        return self._out


class _DeviceMega:
    """A persistent launch in flight on the card: ``query()`` polls its
    completion event; ``result()`` rebuilds the host record from the
    context words the kernel wrote back (the buffers it wrote in place)."""

    def __init__(self, launch, bufs):
        self._launch, self._bufs = launch, bufs

    def query(self) -> bool:
        return self._launch.query()

    def result(self):
        words, n_chunks = self._launch.result()
        return ContextRecord.from_words(words), self._bufs, n_chunks


def make_megakernel(kd, device: Optional[torch.device] = None):
    """The megakernel entry point:

        mega(ctx, bufs, ints, floats, budget, flag, after_chunk=None)
            -> launch   (launch.query(); launch.result() -> (ctx, bufs,
                         n_chunks))

    The whole chunk loop of a task in one launch: it runs chunks of
    ``budget`` while the context is not done, reads ``flag`` after each
    one (the last included) and stops at the first boundary ``k >= flag``
    when ``flag != 0``.  It runs at least one chunk unless the context is
    already done.  ``done == 0`` after the launch is exactly "the flag
    fired".

    On a CUDA ``device`` it binds the kernel's persistent entry
    (``KernelDef.mega``; every built-in task has one: M1 for the blur
    tasks, M2/M3 for the surrogate LM, M4/M5 for the attention LM): one
    cooperative launch on the current stream that keeps the context on the
    card; the host record comes back from the words it writes.  A kernel
    without one raises ``NotImplementedError``: on the card nothing runs
    the host loop instead.  Elsewhere it returns
    the plain version, a host loop over ``make_pipelined_chunk(kd.fn)``
    with the reference's stop rule, which calls ``after_chunk()`` after
    each chunk, before the flag is read.  Both publish the chunks done so
    far in ``flag.progress()``.
    """
    if device is not None and torch.device(device).type == "cuda":
        if kd.mega is None:
            raise NotImplementedError(
                f"engine='megakernel' on the card runs kernels that have a "
                f"persistent entry (KernelDef.mega); {kd.name} has none: use "
                f"'pipelined' or 'sync'")
        entry = kd.mega

        def mega(ctx, bufs, ints, floats, budget, flag, after_chunk=None):
            return _DeviceMega(entry(ctx.to_words(), bufs, ints, floats,
                                     int(budget), flag), bufs)

        return mega

    chunk = make_pipelined_chunk(kd.fn)

    def mega(ctx, bufs, ints, floats, budget, flag, after_chunk=None):
        k = 0
        flag.set_progress(0)
        while ctx.done == 0:
            ctx, bufs, _ = chunk(ctx, bufs, ints, floats, budget)
            k += 1
            flag.set_progress(k)
            if after_chunk is not None:
                after_chunk()
            f = flag.read()
            if f != 0 and k >= f:
                break
        return MegaDone(ctx, bufs, k)

    return mega


def run_to_completion(chunk_fn, ctx, state, ints, floats, budget: int,
                      max_chunks: int = 100000):
    """Host loop for tests: run chunks until done (no scheduler)."""
    chunks = 0
    while int(ctx.done) == 0 and chunks < max_chunks:
        ctx = ctx.with_budget(budget)
        ctx, state = chunk_fn(ctx, state, ints, floats)
        chunks += 1
    return ctx, state, chunks
