"""The blur kernel module of the port against the reference.

On the CPU the port's wrapper takes the plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode (median bitwise,
gaussian within 1e-6) and whole tasks against ``iterated_blur_ref``.  The
hand-written CUDA kernel runs only on the card: its tests are in
``test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.blur import ops as ref_ops  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro.kernels.blur.tasks import make_image as ref_make_image  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.context import ContextRecord  # noqa: E402
from repro_torch.core.preemption import run_to_completion  # noqa: E402
from repro_torch.kernels.blur import kernel as K  # noqa: E402
from repro_torch.kernels.blur import ops, ref  # noqa: E402
from repro_torch.kernels.blur.tasks import ROW_BLOCK, make_image  # noqa: E402

SIZE = 30
GAUSS_TOL = 1e-6  # powers-of-two weights: products exact, sums in order


def _check(kind, got, want):
    if kind == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_TOL)


@pytest.mark.parametrize("kind", ["median", "gaussian"])
@pytest.mark.parametrize("rb,w", [(32, 128), (32, 256), (8, 128)])
def test_plain_blur_block_matches_reference_pallas(kind, rb, w):
    block = np.random.default_rng(rb * w).random((rb + 2, w + 2),
                                                 dtype=np.float32)
    want = np.asarray(ref_ops.blur_block(jnp.asarray(block), kind))
    got = ops.blur_block(torch.tensor(block), kind)
    assert got.shape == (rb, w) and got.dtype == torch.float32
    _check(kind, got.numpy(), want)


@pytest.mark.parametrize("kind", ["median", "gaussian"])
def test_in_place_row_block_writes_only_its_rows(kind):
    """``blur_rows`` writes rows r*32+1 .. r*32+32, columns 1..W of the
    destination and nothing else."""
    img = torch.tensor(make_image(np.random.default_rng(1), SIZE))
    dst = torch.full_like(img, -1.0)
    r = 2
    ops.blur_rows(img, dst, ROW_BLOCK, r, kind)
    row0 = r * ROW_BLOCK
    want = ref.blur_block(img[row0:row0 + ROW_BLOCK + 2], kind)
    torch.testing.assert_close(dst[row0 + 1:row0 + ROW_BLOCK + 1, 1:-1],
                               want, rtol=0, atol=0)
    mask = torch.ones_like(dst, dtype=torch.bool)
    mask[row0 + 1:row0 + ROW_BLOCK + 1, 1:-1] = False
    assert bool((dst[mask] == -1.0).all())


def test_make_image_matches_reference():
    a = make_image(np.random.default_rng(5), SIZE)
    b = ref_make_image(np.random.default_rng(5), SIZE)
    assert a.shape == (130, 130)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel,kind", [("MedianBlur", "median"),
                                         ("GaussianBlur", "gaussian")])
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("budget", [1, 4, 100])
def test_whole_task_matches_iterated_reference(kernel, kind, iters, budget):
    img = make_image(np.random.default_rng(iters * 10 + budget), SIZE)
    kd = get_kernel(kernel)
    bufs, ints, floats = kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                   W=SIZE, iters=iters).padded()
    ctx, state, _ = run_to_completion(
        kd.fn, ContextRecord.fresh(), tuple(torch.tensor(b) for b in bufs),
        ints, floats, budget)
    assert ctx.done == 1
    want = np.asarray(iterated_blur_ref(jnp.asarray(img), iters, kind))
    _check(kind, state[iters % 2].numpy(), want)
    # the port's own whole-image oracle agrees too
    _check(kind, state[iters % 2].numpy(),
           ref.iterated_blur_ref(torch.tensor(img), iters, kind).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never takes a CPU tensor (and so never counts one)."""
    before = K.LAUNCHES.total()
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.blur_block(torch.zeros(34, 130), "median")
    assert K.LAUNCHES.total() == before
