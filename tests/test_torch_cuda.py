"""The port on the card: the hand-written CUDA blur kernel against its
plain PyTorch version, and the Client's preempt/resume path through CUDA
streams.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips without a card.  This file imports nothing of
the JAX package, so it runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import Client  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.task import Task  # noqa: E402
from repro_torch.kernels.blur import kernel as K  # noqa: E402
from repro_torch.kernels.blur import ops, ref  # noqa: E402
from repro_torch.kernels.blur.tasks import ROW_BLOCK, make_image  # noqa: E402

GAUSS_TOL = 1e-6  # powers-of-two weights: products exact, sums in order
TIMEOUT = 120

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA blur kernel has "
                    "no CPU mode (on a card: python -m pytest -m cuda "
                    "tests/test_torch_cuda.py)")
    return torch.device("cuda", 0)


def _check(kind, got, want):
    if kind == "median":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=GAUSS_TOL)


@pytest.mark.parametrize("kind", ["median", "gaussian"])
@pytest.mark.parametrize("w", [128, 130, 4096])
def test_cuda_kernel_matches_plain_version(cuda_device, kind, w):
    block = torch.tensor(np.random.default_rng(w).random(
        (ROW_BLOCK + 2, w + 2), dtype=np.float32), device=cuda_device)
    before = K.LAUNCHES[kind]
    got = ops.blur_block(block, kind)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kind] == before + 1
    _check(kind, got, ref.blur_block(block, kind))


def test_cuda_in_place_rows_touch_nothing_else(cuda_device):
    img = torch.tensor(make_image(np.random.default_rng(2), 200),
                       device=cuda_device)
    dst = torch.full_like(img, -1.0)
    ops.blur_rows(img, dst, ROW_BLOCK, 3, "median")
    row0 = 3 * ROW_BLOCK
    _check("median", dst[row0 + 1:row0 + ROW_BLOCK + 1, 1:-1],
           ref.blur_block(img[row0:row0 + ROW_BLOCK + 2], "median"))
    mask = torch.ones_like(dst, dtype=torch.bool)
    mask[row0 + 1:row0 + ROW_BLOCK + 1, 1:-1] = False
    assert bool((dst[mask] == -1.0).all())


def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    block = torch.zeros(34, 130, device=cuda_device)
    with pytest.raises(TypeError):
        K.blur_block(block.double(), "median")
    with pytest.raises(ValueError, match="unit column stride"):
        K.launch(block.t().contiguous().t(), torch.empty(32, 128,
                                                         device=cuda_device),
                 "median")
    with pytest.raises(ValueError, match="halo"):
        K.launch(block, torch.empty(32, 130, device=cuda_device), "median")


def _run(img, n_regions=1, hook=None):
    client = Client(n_regions=n_regions, chunk_budget=2)  # cuda:0 default
    try:
        if hook is not None:
            for r in client.shell.regions:
                r.on_chunk = hook
        kd = get_kernel("MedianBlur")
        task = Task(kernel="MedianBlur", args=kd.bundle(
            img.copy(), np.zeros_like(img), H=200, W=200, iters=3))
        before = K.LAUNCHES.total()
        client.submit(task).result(timeout=TIMEOUT)
        launches = K.LAUNCHES.total() - before
        return task, client.report(), launches
    finally:
        client.shutdown()


def _once(fn):
    fired = []

    def hook(region, task):
        if not fired:
            fired.append(region.rid)
            fn(region, task)
    return hook


def test_cuda_client_preempt_resume_is_bit_identical(cuda_device):
    """Same-region (device clone on the region's stream) and cross-region
    (materialize after the producing stream's event) resumes both equal
    an unpreempted run, and no row block runs twice."""
    img = make_image(np.random.default_rng(3), 200)  # pads to 256: 8 blocks
    base, rep, n = _run(img)
    assert rep["reconfig"]["regions"][0]["kernel_mode"] == "cuda"
    assert n == 3 * 8
    want = ref.iterated_blur_ref(torch.tensor(img, device=cuda_device), 3,
                                 "median").cpu().numpy()
    np.testing.assert_array_equal(base.result[1], want)

    same, rep, n = _run(img, hook=_once(lambda r, t: r.request_preempt()))
    assert same.n_preemptions == 1 and rep["host_spills_avoided"] == 1
    assert n == 3 * 8

    def move(region, task):
        region.begin_drain()
        region.request_preempt()

    cross, rep, n = _run(img, n_regions=2, hook=_once(move))
    assert cross.n_preemptions == 1 and len(set(cross.region_history)) == 2
    assert n == 3 * 8
    for t in (same, cross):
        for got, exp in zip(t.result, base.result):
            np.testing.assert_array_equal(got, exp)
