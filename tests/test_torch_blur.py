"""The blur kernel module of the port against the reference.

On the CPU the port's wrapper takes the plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode (median bitwise,
gaussian within 1e-6) and whole tasks against ``iterated_blur_ref``.  The
hand-written CUDA kernel runs only on the card: its tests are in
``test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

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
from repro_torch.kernels.blur import tasks  # noqa: E402
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


@pytest.mark.parametrize("kind", ["median", "gaussian"])
@pytest.mark.parametrize("r,n_blocks", [(0, 4), (1, 2), (2, 1)])
def test_in_place_run_writes_only_its_rows(kind, r, n_blocks):
    """A run of ``n_blocks`` row blocks from block ``r`` writes rows
    r*32+1 .. (r+n_blocks)*32, columns 1..W, equal to blurring each block
    on its own, and nothing else."""
    img = torch.tensor(make_image(np.random.default_rng(2), SIZE * 4))
    dst = torch.full_like(img, -1.0)
    ops.blur_rows(img, dst, ROW_BLOCK, r, kind, n_blocks)
    for b in range(r, r + n_blocks):
        row0 = b * ROW_BLOCK
        want = ref.blur_block(img[row0:row0 + ROW_BLOCK + 2], kind)
        torch.testing.assert_close(dst[row0 + 1:row0 + ROW_BLOCK + 1, 1:-1],
                                   want, rtol=0, atol=0)
    mask = torch.ones_like(dst, dtype=torch.bool)
    mask[r * ROW_BLOCK + 1:(r + n_blocks) * ROW_BLOCK + 1, 1:-1] = False
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


# -- the task layer's launches: one per run of row blocks ---------------------

TASK_SIZE = 500  # pads to [514, 514]: 16 row blocks a pass, more than budget


@pytest.mark.parametrize("kernel,kind", [("MedianBlur", "median"),
                                         ("GaussianBlur", "gaussian")])
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("budget", range(1, 10))
def test_task_launches_one_run_per_pass_per_chunk(monkeypatch, kernel, kind,
                                                  iters, budget):
    """With a recording stub in front of the launch: each pass's row blocks
    are covered exactly once and in order, no launch spans two passes,
    the row blocks of one pass within a chunk are one launch (so at most 2
    launches a chunk), and the images still equal the reference's
    (median bitwise, gaussian within 1e-6)."""
    chunks = []

    def record(src, dst, row_block, r, kind_, n_blocks=1):
        assert row_block == ROW_BLOCK and kind_ == kind
        chunks[-1].append((src, dst, r, n_blocks))
        ops.blur_rows(src, dst, row_block, r, kind_, n_blocks)

    monkeypatch.setattr(tasks, "blur_rows", record)
    img = make_image(np.random.default_rng(iters * 10 + budget), TASK_SIZE)
    n_rb = (img.shape[0] - 2) // ROW_BLOCK
    kd = get_kernel(kernel)
    bufs, ints, floats = kd.bundle(img.copy(), np.zeros_like(img),
                                   H=TASK_SIZE, W=TASK_SIZE,
                                   iters=iters).padded()
    state = tuple(torch.tensor(b) for b in bufs)
    ctx = ContextRecord.fresh()
    while ctx.done == 0:
        chunks.append([])
        ctx, state = kd.fn(ctx.with_budget(budget), state, ints, floats)
        assert len(chunks) < 1000
    ping, pong = state[0], state[1]
    covered = []
    for launches in chunks:
        assert len(launches) <= 2
        # one launch per pass a chunk touches: never two of the same image
        assert len({id(src) for src, *_ in launches}) == len(launches)
        for src, dst, r, n in launches:
            assert (src is ping and dst is pong) or (src is pong
                                                     and dst is ping)
            covered += [(src is ping, b) for b in range(r, r + n)]
    assert covered == [(k % 2 == 0, b) for k in range(iters)
                       for b in range(n_rb)]
    want = np.asarray(iterated_blur_ref(jnp.asarray(img), iters, kind))
    _check(kind, state[iters % 2].numpy(), want)


# -- the kernel's median order, rehearsed in plain torch ---------------------

def _column_sort_median(block: torch.Tensor) -> torch.Tensor:
    """``csrc/blur.cu``'s median: sort each vertical triple, then
    med3(max of the minima, med3 of the middles, min of the maxima)."""
    lo_, hi_ = torch.minimum, torch.maximum

    def med3(a, b, c):
        return hi_(lo_(a, b), lo_(hi_(a, b), c))

    a, b, c = block[:-2], block[1:-1], block[2:]
    l1, h1 = lo_(a, b), hi_(a, b)
    m1 = hi_(l1, c)
    lo, mid, hi = lo_(l1, c), lo_(h1, m1), hi_(h1, m1)
    w = block.shape[1] - 2
    cols = [slice(j, j + w) for j in range(3)]
    return med3(hi_(hi_(lo[:, cols[0]], lo[:, cols[1]]), lo[:, cols[2]]),
                med3(mid[:, cols[0]], mid[:, cols[1]], mid[:, cols[2]]),
                lo_(lo_(hi[:, cols[0]], hi[:, cols[1]]), hi[:, cols[2]]))


@pytest.mark.parametrize("levels", [None, 2, 5])
def test_column_sort_median_is_bitwise_the_network(levels):
    """The exact column-sort selection returns the reference network's
    value bitwise, ties (few distinct levels) and the zero ring included."""
    rng = np.random.default_rng(levels or 0)
    block = rng.random((66, 258), dtype=np.float32)
    if levels:
        block = np.floor(block * levels).astype(np.float32) / levels
    block[0], block[:, 0] = 0.0, 0.0
    want = np.asarray(ref_ops.blur_block(jnp.asarray(block), "median"))
    got = _column_sort_median(torch.tensor(block))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ref.blur_block(torch.tensor(block), "median"))


@pytest.mark.parametrize("rows,width,want", [
    (256, 4096, 8),    # a budget-8 run: 16 x 32 = 512 blocks
    (224, 4096, 4),    # 7 row blocks: 8 rows would leave 448 blocks
    (32, 4096, 1),     # one row block: 16 x 32 = 512 blocks
    (4096, 4096, 8),   # a whole image: 16 x 512 blocks
    (32, 128, 1)])
def test_rows_per_thread_plan(rows, width, want):
    assert K.rows_per_thread(rows, width) == want
