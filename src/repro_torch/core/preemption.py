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
"""
from __future__ import annotations

from typing import Any, Callable

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


def run_to_completion(chunk_fn, ctx, state, ints, floats, budget: int,
                      max_chunks: int = 100000):
    """Host loop for tests: run chunks until done (no scheduler)."""
    chunks = 0
    while int(ctx.done) == 0 and chunks < max_chunks:
        ctx = ctx.with_budget(budget)
        ctx, state = chunk_fn(ctx, state, ints, floats)
        chunks += 1
    return ctx, state, chunks
