"""Parity of the port's host-side context machinery with the reference.

The same numpy inputs go through the reference's jitted chunk (its Pallas
blur in interpret mode) and through the port's host-controlled chunk; every
``ContextRecord`` field must be equal after every chunk, and a commit must
carry a task across the two packages in both directions.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.controller.kernels import get_kernel as ref_get_kernel  # noqa: E402
from repro.core import context as RC  # noqa: E402
from repro.core.preemption import for_save as ref_for_save  # noqa: E402
from repro.core.preemption import run_to_completion as ref_run  # noqa: E402
from repro.kernels.blur.tasks import make_image  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.context import (ContextBank, ContextRecord,  # noqa: E402
                                      N_CTX, from_reference, to_reference)
from repro_torch.core.preemption import for_save, run_to_completion  # noqa: E402

SIZE = 30  # pads to [130, 130]: 4 row blocks per iteration
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")
KERNELS = ("MedianBlur", "GaussianBlur")


_jit = functools.lru_cache(maxsize=None)(jax.jit)


def _ref_chunk(kernel):
    return _jit(ref_get_kernel(kernel).fn)


def _ref_fields(ctx):
    return {f: np.asarray(getattr(ctx, f)) for f in FIELDS}


def _assert_same_ctx(port_ctx, ref_fields, where):
    got = port_ctx.fields()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref_fields[f],
                                      err_msg=f"{f} differs {where}")


def _bundles(kernel, iters, seed=0):
    img = make_image(np.random.default_rng(seed), SIZE)
    ref_b = ref_get_kernel(kernel).bundle(img.copy(), np.zeros_like(img),
                                          H=SIZE, W=SIZE, iters=iters)
    port_b = get_kernel(kernel).bundle(img.copy(), np.zeros_like(img),
                                       H=SIZE, W=SIZE, iters=iters)
    return img, ref_b, port_b


def _ref_chunks(kernel, bundle, budget, ctx=None, state=None):
    """Run the reference chunk by chunk; yields (fields, state) per chunk."""
    bufs, ints, floats = bundle.padded()
    chunk = _ref_chunk(kernel)
    ctx = RC.ContextRecord.fresh() if ctx is None else ctx
    state = tuple(jnp.asarray(b) for b in bufs) if state is None else state
    out = []
    while int(ctx.done) == 0:
        ctx = ctx.with_budget(budget)
        ctx, state = chunk(ctx, state, ints, floats)
        out.append((_ref_fields(ctx), state))
        assert len(out) < 2000
    return out


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("budget", range(1, 10))
def test_context_fields_match_reference_after_every_chunk(budget, iters,
                                                          kernel):
    """Every field (budget decremented by the outer k loop too, intr,
    clear-on-complete) equals the reference after every chunk, and the
    images agree: median bitwise, gaussian within 1e-6."""
    _, ref_b, port_b = _bundles(kernel, iters)
    ref_trace = _ref_chunks(kernel, ref_b, budget)

    bufs, ints, floats = port_b.padded()
    fn = get_kernel(kernel).fn
    ctx = ContextRecord.fresh()
    state = tuple(torch.tensor(b) for b in bufs)
    for n, (ref_fields, _) in enumerate(ref_trace):
        assert ctx.done == 0, f"port finished early, at chunk {n}"
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
        _assert_same_ctx(ctx, ref_fields, f"after chunk {n}")
    assert ctx.done == 1
    ref_state = ref_trace[-1][1]
    for slot in (0, 1):
        want = np.asarray(ref_state[slot])
        got = state[slot].numpy()
        if kernel == "MedianBlur":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- the tests/test_context.py cases, held against the reference -----------

def _port_sum_kernel(ctx, state, ints, floats):
    n = int(ints[0])

    def body(ctx, i, acc):
        return ctx.checkpoint(0, i + 1), acc + i

    ctx, acc = for_save(ctx, 0, 0, n, 1, body, state)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, acc


def _ref_sum_kernel(ctx, state, ints, floats):
    n = ints[0]

    def body(ctx, i, acc):
        return ctx.checkpoint(0, i + 1), acc + i

    ctx, acc = ref_for_save(ctx, 0, 0, n, 1, body, state)
    done = ctx.intr == 0
    ctx = jax.tree.map(lambda a, b: jnp.where(done, a, b), ctx.finish(), ctx)
    return ctx, acc


def _port_nested_kernel(ctx, state, ints, floats):
    K, R = int(ints[0]), int(ints[1])

    def inner(ctx, r, acc):
        return ctx.checkpoint(1, r + 1), acc + 1

    def outer(ctx, k, acc):
        ctx = ctx.checkpoint(0, k)
        ctx, acc = for_save(ctx, 1, 0, R, 1, inner, acc)
        if ctx.intr == 0:
            ctx = ctx.checkpoint(0, k + 1)
        return ctx, acc

    ctx, acc = for_save(ctx, 0, 0, K, 1, outer, state)
    if ctx.intr == 0:
        ctx = ctx.finish()
    return ctx, acc


def _ref_nested_kernel(ctx, state, ints, floats):
    K, R = ints[0], ints[1]

    def inner(ctx, r, acc):
        return ctx.checkpoint(1, r + 1), acc + 1

    def outer(ctx, k, acc):
        ctx = ctx.checkpoint(0, k)
        ctx, acc = ref_for_save(ctx, 1, 0, R, 1, inner, acc)
        adv = ctx.checkpoint(0, k + 1)
        ok = ctx.intr == 0
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b), adv, ctx), acc

    ctx, acc = ref_for_save(ctx, 0, 0, K, 1, outer, state)
    done = ctx.intr == 0
    ctx = jax.tree.map(lambda a, b: jnp.where(done, a, b), ctx.finish(), ctx)
    return ctx, acc


def _lockstep(port_fn, ref_fn, ints_list, budget, max_chunks=500):
    """Run both kernels chunk by chunk; contexts and accumulators must
    agree after every chunk.  Returns (port ctx, acc, chunks)."""
    ints = np.asarray(ints_list + [0] * (8 - len(ints_list)), np.int32)
    floats = np.zeros((8,), np.float32)
    ref_chunk = _jit(ref_fn)
    rctx, racc = RC.ContextRecord.fresh(), jnp.int32(0)
    pctx, pacc = ContextRecord.fresh(), 0
    chunks = 0
    while pctx.done == 0 and chunks < max_chunks:
        rctx, racc = ref_chunk(rctx.with_budget(budget), racc,
                               jnp.asarray(ints), jnp.asarray(floats))
        pctx, pacc = port_fn(pctx.with_budget(budget), pacc, ints, floats)
        _assert_same_ctx(pctx, _ref_fields(rctx), f"after chunk {chunks}")
        assert pacc == int(racc)
        chunks += 1
    assert int(rctx.done) == pctx.done
    return pctx, pacc, chunks


@pytest.mark.parametrize("budget", [1, 2, 3, 5, 100])
def test_for_save_resume_equivalence(budget):
    n = 13
    ctx, acc, chunks = _lockstep(_port_sum_kernel, _ref_sum_kernel, [n],
                                 budget)
    assert acc == n * (n - 1) // 2
    assert ctx.done == 1
    assert chunks == -(-n // budget)


@pytest.mark.parametrize("budget", [1, 2, 3, 4, 7, 1000])
@pytest.mark.parametrize("K,R", [(3, 4), (2, 2), (1, 5), (4, 1)])
def test_nested_for_save_all_budgets(budget, K, R):
    """budget == inner-loop multiples must not livelock, and the port
    takes the reference's path through every boundary."""
    ctx, _, chunks = _lockstep(_port_nested_kernel, _ref_nested_kernel,
                               [K, R], budget)
    assert chunks < 500, "livelock: kernel never finished"
    assert ctx.done == 1


def test_checkpoint_clears_after_completion():
    def kern(ctx, state, ints, floats):
        def body(ctx, i, s):
            return ctx.checkpoint(0, i + 1), s + i
        ctx, s = for_save(ctx, 0, 0, 5, 1, body, state)
        return ctx.finish(), s

    ctx, s = kern(ContextRecord.fresh(budget=100), 0, None, None)
    assert ctx.saved[0] == 0 and ctx.var[0] == 0 and s == 10
    assert ctx.var.dtype == np.int32 and ctx.var.shape == (N_CTX,)


def test_context_bank_double_buffer_torn_write():
    """The paper's `valid` flag: a commit interrupted mid-save must leave
    the previous commit restorable."""
    bank = ContextBank()
    bank.commit(ContextRecord.fresh().checkpoint(0, 42), payload=("p1",))
    bank.interrupt_next_commit = True  # async reset lands during the save
    c2 = ContextRecord.fresh().checkpoint(0, 99)
    bank.commit(c2, payload=("p2",))
    got = bank.restore()
    assert got is not None
    assert got.context.var[0] == 42  # previous commit still valid
    assert got.payload == ("p1",)
    bank.commit(c2, payload=("p2",))
    assert bank.restore().context.var[0] == 99


def test_fields_roundtrip():
    c = ContextRecord.fresh(budget=7).checkpoint(3, 11).declare(2, 1, 3)
    c2 = ContextRecord.from_fields(c.fields())
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(c2, f)),
                                      np.asarray(getattr(c, f)))


# -- carrying a task across the two packages -------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("cut", [1, 5])
def test_reference_preempted_task_finishes_in_port(kernel, cut):
    """Preempt in the reference after ``cut`` chunks, commit through its
    bank, carry the commit over with ``from_reference`` and finish in the
    port: the images equal an uninterrupted reference run."""
    iters, budget = 3, 2
    _, ref_b, port_b = _bundles(kernel, iters, seed=3)
    full = _ref_chunks(kernel, ref_b, budget)
    assert cut < len(full)

    bufs, ints, floats = ref_b.padded()
    chunk = _ref_chunk(kernel)
    rctx, rstate = RC.ContextRecord.fresh(), tuple(jnp.asarray(b)
                                                   for b in bufs)
    for _ in range(cut):
        rctx, rstate = chunk(rctx.with_budget(budget), rstate, ints, floats)
    bank = RC.ContextBank()
    bank.commit(rctx, payload=rstate, tid=7)
    committed = from_reference(bank.restore().materialize())
    assert committed.tid == 7

    _, pints, pfloats = port_b.padded()
    state = tuple(torch.tensor(b) for b in committed.payload)
    ctx, state, _ = run_to_completion(get_kernel(kernel).fn,
                                      committed.context, state, pints,
                                      pfloats, budget)
    assert ctx.done == 1
    _assert_same_ctx(ctx, full[-1][0], "at completion")
    for slot in (0, 1):
        want = np.asarray(full[-1][1][slot])
        if kernel == "MedianBlur":
            np.testing.assert_array_equal(state[slot].numpy(), want)
        else:
            np.testing.assert_allclose(state[slot].numpy(), want, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("kernel", KERNELS)
def test_port_preempted_task_finishes_in_reference(kernel):
    """The inverse: preempt in the port, ``to_reference``, rebuild the
    reference's commit from the leaves and finish there."""
    iters, budget, cut = 2, 3, 2
    _, ref_b, port_b = _bundles(kernel, iters, seed=4)
    full = _ref_chunks(kernel, ref_b, budget)

    bufs, ints, floats = port_b.padded()
    fn = get_kernel(kernel).fn
    ctx, state = ContextRecord.fresh(), tuple(torch.tensor(b) for b in bufs)
    for _ in range(cut):
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
    bank = ContextBank()
    bank.commit(ctx, payload=state, tid=3)
    leaves = to_reference(bank.restore())
    ref_committed = RC.Committed(
        leaves["seqno"],
        RC.ContextRecord(**{f: jnp.asarray(v)
                            for f, v in leaves["context"].items()}),
        leaves["payload"], tid=leaves["tid"])

    rbufs, rints, rfloats = ref_b.padded()
    rctx, rstate, _ = ref_run(_ref_chunk(kernel), ref_committed.context,
                              tuple(jnp.asarray(b)
                                    for b in ref_committed.payload),
                              rints, rfloats, budget)
    assert int(rctx.done) == 1
    for slot in (0, 1):
        want = np.asarray(full[-1][1][slot])
        if kernel == "MedianBlur":
            np.testing.assert_array_equal(np.asarray(rstate[slot]), want)
        else:
            np.testing.assert_allclose(np.asarray(rstate[slot]), want,
                                       rtol=0, atol=1e-6)
