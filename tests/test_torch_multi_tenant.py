"""The multi-tenant pieces of the port on the CPU: ``register_kernel_def``
and ``make_chunk_fn`` beside the reference's, and the twin of
``examples/multi_tenant_serve.py`` (``examples/torch_multi_tenant_serve.py``)
at its reduced size on ``devices=["cpu"]``.

The twin's serving requests arrive at the training task's first chunk
boundary from the regions' ``on_chunk`` hook, which holds the workers until
the scheduler has asked the training region to preempt; the training task
must be preempted at least once, complete, and end bit for bit equal to an
uninterrupted run of the same task.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

from repro.controller import kernels as RK  # noqa: E402
from repro.core import preemption as RPRE  # noqa: E402
from repro_torch import Client  # noqa: E402
from repro_torch.controller import abi  # noqa: E402
from repro_torch.controller import kernels as K  # noqa: E402
from repro_torch.core.context import ContextRecord  # noqa: E402
from repro_torch.core.preemption import make_chunk_fn, run_to_completion  # noqa: E402
from repro_torch.core.task import Task  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SIZE, TIMEOUT = 30, 120


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_multi_tenant_serve", ROOT / "examples" /
        "torch_multi_tenant_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_register_kernel_def_runs_through_client_like_the_decorator():
    """A ``KernelDef`` built by hand from MedianBlur's fields, registered
    with ``register_kernel_def`` (the reference's ``:98-99``), runs through
    ``Client`` bitwise equal to the decorator-registered MedianBlur."""
    assert set(RK.__dict__) >= {"register_kernel_def", "KernelDef"}
    kd = K.get_kernel("MedianBlur")
    hand = K.KernelDef(name="HandMedianBlur", backend=kd.backend, fn=kd.fn,
                       ktile_args=kd.ktile_args, int_args=kd.int_args,
                       float_args=kd.float_args,
                       default_budget=kd.default_budget,
                       library=kd.library)
    K.register_kernel_def(hand)
    assert K.get_kernel("HandMedianBlur") is hand
    assert "HandMedianBlur" in K.kernel_names()
    img = make_image(np.random.default_rng(4), SIZE)
    client = Client(n_regions=1, device="cpu", chunk_budget=2,
                    prefetch=False)
    try:
        out = [client.submit(Task(
            kernel=name, args=kd.bundle(img.copy(), np.zeros_like(img),
                                        H=SIZE, W=SIZE, iters=3),
            priority=4)).result(timeout=TIMEOUT)
            for name in ("MedianBlur", "HandMedianBlur")]
    finally:
        client.shutdown()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(out[0][0], img)  # the blur ran


def test_make_chunk_fn_is_the_reference_wrapper():
    """One chunk call is one kernel call, as the reference's
    ``make_chunk_fn``; run to completion it gives the direct result."""
    calls = []

    def kernel(ctx, state, ints, floats):
        calls.append(int(ints[0]))
        return ctx.finish(), tuple(s + ints[0] for s in state)

    chunk = make_chunk_fn(kernel)
    ctx, state = chunk(ContextRecord.fresh(), (torch.zeros(2),),
                       np.array([3], np.int32), np.zeros(1, np.float32))
    rctx, rstate = RPRE.make_chunk_fn(kernel)(
        ContextRecord.fresh(), (np.zeros(2),), np.array([3], np.int32),
        np.zeros(1, np.float32))
    assert calls == [3, 3] and ctx.done == 1
    np.testing.assert_array_equal(state[0].numpy(), rstate[0])
    kd = K.get_kernel("MedianBlur")
    img = make_image(np.random.default_rng(5), SIZE)
    bufs, ints, floats = kd.bundle(img, np.zeros_like(img), H=SIZE, W=SIZE,
                                   iters=2).padded()
    _, want, _ = run_to_completion(kd.fn, ContextRecord.fresh(),
                                   tuple(torch.tensor(b) for b in bufs),
                                   ints, floats, budget=10 ** 6)
    ctx, got = make_chunk_fn(kd.fn)(ContextRecord.fresh().with_budget(10 ** 6),
                                    tuple(torch.tensor(b) for b in bufs),
                                    ints, floats)
    assert ctx.done == 1
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_regions", [1, 2])
def test_multi_tenant_twin_preempts_training_and_matches_uninterrupted(
        n_regions):
    ex = _example()
    width = abi.N_BUF_SLOTS
    got = ex.run("cpu", n_regions=n_regions)
    want = ex.run("cpu", n_regions=n_regions, serve=False)
    assert abi.N_BUF_SLOTS == width  # the widening is undone
    assert got["preemptions"] >= 1 and want["preemptions"] == 0
    assert got["report"]["n_done"] == 1 + ex.N_REQUESTS
    assert len(got["logits"]) == ex.N_REQUESTS
    for logits in got["logits"]:
        assert logits.shape == (4, ex.CFG.vocab_size)
        assert np.isfinite(logits).all()
    assert len(got["state"]) == len(want["state"])
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(a, b)
    # the step counter rode along: 12 steps in both runs
    leaves, spec, _ = ex.initial_state()
    step_leaf = [i for i, x in enumerate(leaves) if x.ndim == 0]
    assert [int(got["state"][i]) for i in step_leaf] == [ex.TRAIN_STEPS]
