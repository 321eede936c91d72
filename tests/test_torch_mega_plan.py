"""``kernels/blur/kernel.py``'s ``mega_plan`` (M1's plan: its grid, each
chunk's runs and the grid-wide waits a launch takes) against what the
control flow really does, on the CPU:

- against the plain version of M1 (``core/preemption.make_megakernel``
  over the blur task, what ``ops.blur_mega`` runs on CPU tensors), whose
  runs are recorded at ``tasks.blur_rows`` and cut into chunks by its
  ``after_chunk`` hook, at sizes 30/256/4096 and budgets 1/2/3/8; the
  4096-pixel task records its runs without blurring (the control does not
  read the pixels);
- against the reference's ``make_megakernel`` (``src/repro/core/
  preemption.py``) launched one chunk at a time: the plan from the
  reference's context after every boundary is the tail of the plan from
  the fresh context (sizes 30 and 256);
- resumed from every boundary of a small task through the plain version.

The waits a launch of ``n`` chunks takes are the runs that start a pass
after another run of the same launch; the row blocks are its runs' sum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402

from repro.controller import kernels as R_kernels  # noqa: E402
from repro.core import preemption as R_pre  # noqa: E402
from repro.core.context import ContextRecord as R_Ctx  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.context import ContextRecord  # noqa: E402
from repro_torch.core.preemption import (PreemptFlag,  # noqa: E402
                                         make_megakernel)
from repro_torch.kernels.blur import kernel as K  # noqa: E402
from repro_torch.kernels.blur import tasks as T  # noqa: E402

ITERS = 3
BUDGETS = (1, 2, 3, 8)
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")


def _padded(size: int) -> int:
    return -(-size // 128) * 128


def _plain_chunks(monkeypatch, size, budget, ctx=None, flag=0):
    """The plain version's chunks from ``ctx`` (fresh by default) with the
    flag at ``flag``: each chunk's runs as ``(pass parity, first,
    n_blocks, ends_pass)``, and the context after the launch.  Runs are
    recorded, not blurred, so the images may be stand-ins of their shape."""
    h = _padded(size)
    n_rb = h // T.ROW_BLOCK
    ping = torch.zeros(1, 1).expand(h + 2, h + 2)
    pong = torch.zeros(1, 1).expand(h + 2, h + 2)
    chunks = [[]]

    def record(src, dst, row_block, r, kind, n_blocks):
        chunks[-1].append((0 if src is ping else 1, r, n_blocks,
                           r + n_blocks == n_rb))

    monkeypatch.setattr(T, "blur_rows", record)
    p_flag = PreemptFlag()
    p_flag.write(flag)
    ctx = ContextRecord.fresh() if ctx is None else ctx
    got, _, n = make_megakernel(get_kernel("MedianBlur"))(
        ctx, (ping, pong), T.task_ints(h, h, ITERS), None, budget, p_flag,
        after_chunk=lambda: chunks.append([])).result()
    assert len(chunks) == n + 1 and chunks[-1] == []
    return [tuple(c) for c in chunks[:-1]], got


def _as_recorded(chunks):
    return [tuple((r.k % 2, r.first, r.n_blocks, r.ends_pass) for r in c)
            for c in chunks]


def _totals(chunks, n):
    """(row blocks, grid-wide waits) of a launch's first ``n`` chunks, from
    its recorded runs."""
    runs = [r for c in chunks[:n] for r in c]
    waits = sum(1 for i, r in enumerate(runs) if i and r[1] == 0)
    return sum(r[2] for r in runs), waits


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("size", [30, 256, 4096])
def test_mega_plan_equals_the_plain_versions_runs(monkeypatch, size, budget):
    """A fresh task's plan: every chunk's runs are the plain version's, in
    order, and the row blocks and grid-wide waits of a launch cut after
    any number of chunks are its runs' count and its pass starts after
    the first run: one a pass end that another run follows."""
    want, ctx = _plain_chunks(monkeypatch, size, budget)
    assert ctx.done == 1
    h = _padded(size)
    plan = K.mega_plan(h, h, ITERS, budget, ContextRecord.fresh().to_words())
    chunks = list(plan.chunks())
    assert _as_recorded(chunks) == want
    assert len(want) <= plan.max_chunks
    n_rb = h // T.ROW_BLOCK
    assert plan.n_rb == n_rb and plan.run_blocks == min(budget, n_rb)
    assert plan.grid == max(r[2] for c in want for r in c) \
        * K.tiles_per_row_block(h)
    for n in range(len(want) + 1):
        assert plan.totals(n) == _totals(want, n), n
    rows, waits = plan.totals(len(want))
    assert rows == ITERS * n_rb and waits == ITERS - 1 <= len(want)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("size", [30, 256])
def test_mega_plan_resumes_from_the_references_boundaries(size, budget):
    """The reference's ``make_megakernel`` launched with the flag at 1
    (one chunk a launch) until done: after every boundary the plan from
    its context is the tail of the fresh plan, and the plan from its
    final context runs nothing."""
    h = _padded(size)
    kd = R_kernels.get_kernel("MedianBlur")
    img = T.make_image(np.random.default_rng(size + budget), size)
    bufs, ints, floats = kd.bundle(img, np.zeros_like(img), H=h, W=h,
                                   iters=ITERS).padded()
    mega = R_pre.make_megakernel(kd.fn)
    flag = R_pre.PreemptFlag()
    flag.write(1)
    state, ctx = tuple(jnp.asarray(b) for b in bufs), R_Ctx.fresh()
    full = list(K.mega_plan(h, h, ITERS, budget,
                            ContextRecord.fresh().to_words()).chunks())
    for b in range(1, len(full) + 1):
        ctx, state, done, n = mega(ctx, state, ints, floats,
                                   jnp.int32(budget), flag.device)
        assert int(n) == 1
        words = ContextRecord(*(np.asarray(getattr(ctx, f))
                                for f in FIELDS)).to_words()
        plan = K.mega_plan(h, h, ITERS, budget, words)
        assert list(plan.chunks()) == full[b:], f"boundary {b}"
        assert plan.done == bool(int(done)) == (b == len(full))
    assert plan.totals(5) == (0, 0)


@pytest.mark.parametrize("budget", [2, 3])
def test_mega_plan_resumes_from_every_boundary(monkeypatch, budget):
    """A small task stopped at each boundary ``k`` by the plain version's
    flag, then resumed: the plan from the context at ``k`` gives the
    resumed launch's chunks, row blocks and waits (its first run waits for
    nothing even when it starts a pass)."""
    h = _padded(30)
    full, _ = _plain_chunks(monkeypatch, 30, budget)
    assert len(full) >= 3
    for k in range(1, len(full)):
        head, ctx = _plain_chunks(monkeypatch, 30, budget, flag=k)
        assert head == full[:k] and ctx.done == 0
        tail, end = _plain_chunks(monkeypatch, 30, budget, ctx=ctx)
        assert tail == full[k:] and end.done == 1
        plan = K.mega_plan(h, h, ITERS, budget, ctx.to_words())
        assert _as_recorded(plan.chunks()) == tail
        for n in range(len(tail) + 1):
            assert plan.totals(n) == _totals(tail, n), (k, n)


def test_mega_plan_of_a_done_context_runs_nothing():
    words = ContextRecord.fresh().finish().to_words()
    plan = K.mega_plan(128, 128, ITERS, 8, words)
    assert list(plan.chunks()) == [] and plan.totals(3) == (0, 0)
    assert K.mega_plan(128, 128, 0, 8, ContextRecord.fresh().to_words()
                       ).totals(1) == (0, 0)
