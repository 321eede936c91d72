"""The port on the card: the hand-written CUDA kernels (blur, the
persistent blur megakernel M1, flash attention, decode attention, RG-LRU
scan, RWKV-6, the persistent LM kernels M2-M5) against their plain
PyTorch versions, the Client's
preempt/resume path through CUDA streams (the elastic pool's grow and
drain among them, the megakernel engine's flag exits, and a migration
between two shells of a cluster frontend),
token serving on the attention LM, ``serve lm`` on the recurrent
models and on the encoder-decoder (reduced whisper-tiny), and DBRX-132B's
MoE layer over the production mesh.  A CUDA kernel has no CPU mode, so
every test here carries the
``cuda`` marker and skips without a card.  This file imports nothing of
the JAX package, so it runs where JAX is absent:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402

from repro_torch import Client  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.context import ContextRecord  # noqa: E402
from repro_torch.core.preemption import (PreemptFlag,  # noqa: E402
                                         make_megakernel)
from repro_torch.core.streams import mark_ready  # noqa: E402
from repro_torch.core.task import Task  # noqa: E402
from repro_torch.kernels.blur import kernel as K  # noqa: E402
from repro_torch.kernels.blur import ops, ref  # noqa: E402
from repro_torch.kernels.blur.tasks import (KERNELS, ROW_BLOCK,  # noqa: E402
                                            make_image, task_ints)
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as GK  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as gops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as gref  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wref  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.serving.attention import (AttentionParams,  # noqa: E402
                                           attention_oracle_stream)

GAUSS_TOL = 1e-6  # powers-of-two weights: products exact, sums in order
# attention: the kernels sum in another order than the plain versions
# (tiles, fmaf, warp butterflies); f32 tolerance as the reference's tests,
# bf16 for one bf16 rounding of the output
F32_TOL, BF16_TOL = 2e-5, 2e-2
# recurrences: the reference's tolerances (tests/test_kernels.py)
SCAN_TOL, RWKV_TOL = 1e-5, 1e-4
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
@pytest.mark.parametrize("w", [128, 129, 130, 4096])
@pytest.mark.parametrize("n_blocks", [1, 2, 7, 8])
def test_cuda_kernel_matches_plain_version(cuda_device, kind, w, n_blocks):
    """1, 2, 7 and 8 row blocks in one launch (at width 4096 the plan's
    1, 2, 4 and 8 rows a thread), at widths 128, 130 and 4096 (8-byte loads) and 129 (an odd row
    stride: 4-byte loads)."""
    block = torch.tensor(np.random.default_rng(w + n_blocks).random(
        (n_blocks * ROW_BLOCK + 2, w + 2), dtype=np.float32),
        device=cuda_device)
    before = K.LAUNCHES[kind]
    got = ops.blur_block(block, kind)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kind] == before + 1
    _check(kind, got, ref.blur_block(block, kind))


@pytest.mark.parametrize("kind", ["median", "gaussian"])
@pytest.mark.parametrize("rows,per_thread", [(5, 1), (67, 2), (227, 4),
                                              (253, 8)])
def test_cuda_kernel_every_rows_per_thread(cuda_device, kind, rows,
                                           per_thread):
    """Each instantiation, reached through the plan at width 4096 by its
    row count, with a ragged last row group."""
    assert K.rows_per_thread(rows, 4096) == per_thread
    block = torch.tensor(np.random.default_rng(rows).random(
        (rows + 2, 4096 + 2), dtype=np.float32), device=cuda_device)
    got = ops.blur_block(block, kind)
    torch.cuda.synchronize()
    _check(kind, got, ref.blur_block(block, kind))


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_cuda_in_place_rows_touch_nothing_else(cuda_device, n_blocks):
    """A run of ``n_blocks`` row blocks in place writes exactly its rows."""
    img = torch.tensor(make_image(np.random.default_rng(2), 200),
                       device=cuda_device)
    dst = torch.full_like(img, -1.0)
    before = (K.LAUNCHES["median"], K.ROW_BLOCKS["median"])
    ops.blur_rows(img, dst, ROW_BLOCK, 3, "median", n_blocks)
    assert (K.LAUNCHES["median"], K.ROW_BLOCKS["median"]) == (
        before[0] + 1, before[1] + n_blocks)
    row0, rows = 3 * ROW_BLOCK, n_blocks * ROW_BLOCK
    _check("median", dst[row0 + 1:row0 + rows + 1, 1:-1],
           ref.blur_block(img[row0:row0 + rows + 2], "median"))
    mask = torch.ones_like(dst, dtype=torch.bool)
    mask[row0 + 1:row0 + rows + 1, 1:-1] = False
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


# -- M1, the persistent blur megakernel ---------------------------------------

def _mega_images(dev, size, seed=0):
    """The same padded image twice on the card: (kernel's, plain's)
    ping/pong pairs."""
    img = make_image(np.random.default_rng(seed), size)
    a = (torch.tensor(img, device=dev), torch.zeros(img.shape, device=dev))
    return a, tuple(x.clone() for x in a)


def _mega_step(kind, mine, plain, ctx, iters, budget, flag, boundary):
    """One launch of M1 and of its plain version (the host loop through
    ``make_pipelined_chunk`` with B1) from ``ctx`` with the flag at
    ``boundary``: equal context words, chunk counts, images and row
    blocks.  Returns the context after it."""
    flag.write(boundary)
    before = K.ROW_BLOCKS[kind]
    launches = K.MEGA_LAUNCHES[kind]
    launch = K.blur_mega(ctx.to_words(), *mine, kind, iters, budget, flag)
    words, n = launch.result()
    assert K.MEGA_LAUNCHES[kind] == launches + 1
    assert flag.progress() == n  # the kernel's last boundary
    # one grid-wide wait a pass end that another run of the launch follows
    assert launch.waits == launch.plan.totals(n)[1]
    start, end = launch.interval
    assert 0 < start <= end
    rows = K.ROW_BLOCKS[kind] - before
    h, w = mine[0].shape[0] - 2, mine[0].shape[1] - 2
    got = make_megakernel(get_kernel(KERNELS[kind]))(
        ctx, plain, task_ints(h, w, iters), None, budget, flag)
    want, _, want_n = got.result()
    torch.cuda.synchronize()
    plain_rows = K.ROW_BLOCKS[kind] - before - rows
    assert n == want_n
    np.testing.assert_array_equal(words, want.to_words())
    assert rows == plain_rows
    for a, b in zip(mine, plain):
        _check(kind, a, b)
    flag.clear()
    return want


@pytest.mark.parametrize("kind", ["median", "gaussian"])
@pytest.mark.parametrize("size", [30, 256, 4096])
@pytest.mark.parametrize("budget", [1, 2, 3, 8])
def test_cuda_mega_matches_plain_version(cuda_device, kind, size, budget):
    """A whole task in one launch of M1 against its plain version on the
    card: context words, chunks, images (median bitwise, gaussian within
    1e-6), exactly ``iters x H/32`` row blocks, and one grid-wide wait a
    pass end but the last (at size 30, budgets 3 and 8 cross a pass end
    inside a chunk)."""
    mine, plain = _mega_images(cuda_device, size, seed=size + budget)
    flag = PreemptFlag(cuda_device)
    before = K.ROW_BLOCKS[kind]
    ctx = _mega_step(kind, mine, plain, ContextRecord.fresh(), 3, budget,
                     flag, 0)
    assert ctx.done == 1
    n_rb = (mine[0].shape[0] - 2) // ROW_BLOCK
    assert K.ROW_BLOCKS[kind] - before == 2 * 3 * n_rb  # M1's + plain's
    launch = K.blur_mega(ContextRecord.fresh().to_words(), *mine, kind, 3,
                         budget, flag)
    _, n = launch.result()
    assert launch.waits == 2 and launch.plan.totals(n) == (3 * n_rb, 2)


def test_cuda_mega_flag_write_lag(cuda_device):
    """A flag written into a running M1 launch at budget 1 stops it at
    most 2 chunks past the progress the host read right after the write,
    and the images and context words then equal the plain version's
    stopped at that boundary."""
    iters, at_least = 200, 200
    flag = PreemptFlag(cuda_device)
    mine, plain = _mega_images(cuda_device, 4096, seed=13)
    ctx = ContextRecord.fresh()
    launch = K.blur_mega(ctx.to_words(), *mine, "median", iters, 1, flag)
    deadline = time.perf_counter() + TIMEOUT
    while flag.progress() < at_least:
        assert time.perf_counter() < deadline and not launch.query()
    flag.write(1)
    at = flag.progress()
    words, n = launch.result()
    assert 0 <= n - at <= 2, (n, at)
    assert n < iters * 128 and flag.progress() == n
    flag.write(n)
    want, _, want_n = make_megakernel(get_kernel("MedianBlur"))(
        ctx, plain, task_ints(4096, 4096, iters), None, 1, flag).result()
    torch.cuda.synchronize()
    assert want_n == n
    np.testing.assert_array_equal(words, want.to_words())
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    flag.clear()


@pytest.mark.parametrize("kind", ["median", "gaussian"])
def test_cuda_mega_flag_exit_at_every_boundary(cuda_device, kind):
    """From a fresh context, the flag at each boundary ``k`` of a small
    task, then a resume to completion; and the flag at boundary 1 of every
    launch: after every exit M1 equals its plain version."""
    flag = PreemptFlag(cuda_device)
    mine, plain = _mega_images(cuda_device, 30)
    ctx, exits = ContextRecord.fresh(), 0
    while True:
        ctx = _mega_step(kind, mine, plain, ctx, 3, 2, flag, 1)
        if ctx.done:
            break
        exits += 1
    assert exits >= 2
    for k in range(1, exits + 1):
        mine, plain = _mega_images(cuda_device, 30)
        ctx = _mega_step(kind, mine, plain, ContextRecord.fresh(), 3, 2,
                         flag, k)
        assert ctx.done == 0
        ctx = _mega_step(kind, mine, plain, ctx, 3, 2, flag, 0)
        assert ctx.done == 1


def test_cuda_mega_wrapper_rejects_bad_inputs(cuda_device):
    flag = PreemptFlag(cuda_device)
    img = torch.zeros(130, 130, device=cuda_device)
    words = ContextRecord.fresh().to_words()
    with pytest.raises(TypeError):
        K.blur_mega(words, img.double(), img.double(), "median", 1, 1, flag)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.blur_mega(words, img[:100], img[:100].clone(), "median", 1, 1,
                    flag)
    with pytest.raises(ValueError, match="budget"):
        K.blur_mega(words, img, img.clone(), "median", 1, 0, flag)
    with pytest.raises(ValueError, match="PreemptFlag"):
        K.blur_mega(words, img, img.clone(), "median", 1, 1, PreemptFlag())
    with pytest.raises(ValueError, match="context words"):
        K.blur_mega(words[:35], img, img.clone(), "median", 1, 1, flag)


def test_cuda_client_megakernel_flag_exit_is_bit_identical(cuda_device):
    """``Client(engine="megakernel")`` on the card: a task armed to exit
    at boundary 2 resumes (a second launch), launches no B1, and equals
    the pipelined engine's unpreempted run."""
    img = make_image(np.random.default_rng(3), 200)
    base, _, _ = _run(img)
    client = Client(n_regions=1, chunk_budget=2, engine="megakernel")
    try:
        kd = get_kernel("MedianBlur")
        task = Task(kernel="MedianBlur", args=kd.bundle(
            img.copy(), np.zeros_like(img), H=200, W=200, iters=3))
        task.preempt_at_boundary = 2
        before = (K.MEGA_LAUNCHES.total(), K.LAUNCHES.total())
        client.submit(task).result(timeout=TIMEOUT)
        rep = client.report()
    finally:
        client.shutdown()
    assert rep["megakernel_launches"] == 2 and rep["flag_poll_exits"] == 1
    assert (K.MEGA_LAUNCHES.total() - before[0],
            K.LAUNCHES.total() - before[1]) == (2, 0)  # M1 only
    for got, exp in zip(task.result, base.result):
        np.testing.assert_array_equal(got, exp)


def _run(img, n_regions=1, hook=None):
    client = Client(n_regions=n_regions, chunk_budget=2)  # cuda:0 default
    try:
        if hook is not None:
            for r in client.shell.regions:
                r.on_chunk = hook
        kd = get_kernel("MedianBlur")
        task = Task(kernel="MedianBlur", args=kd.bundle(
            img.copy(), np.zeros_like(img), H=200, W=200, iters=3))
        before = (K.ROW_BLOCKS.total(), K.LAUNCHES.total())
        client.submit(task).result(timeout=TIMEOUT)
        counts = (K.ROW_BLOCKS.total() - before[0],
                  K.LAUNCHES.total() - before[1])
        return task, client.report(), counts
    finally:
        client.shutdown()


def _check_counts(counts, rep, budget=2):
    """Every row block ran exactly once through the kernel; the launches
    are at least one per ``budget`` row blocks and at most 2 per chunk."""
    row_blocks, launches = counts
    assert row_blocks == 3 * 8
    assert -(-row_blocks // budget) <= launches <= 2 * rep["chunks"]


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
    an unpreempted run, no row block runs twice, and the launches cover
    runs of row blocks (at most 2 a chunk)."""
    img = make_image(np.random.default_rng(3), 200)  # pads to 256: 8 blocks
    base, rep, n = _run(img)
    assert rep["reconfig"]["regions"][0]["kernel_mode"] == "cuda"
    _check_counts(n, rep)
    want = ref.iterated_blur_ref(torch.tensor(img, device=cuda_device), 3,
                                 "median").cpu().numpy()
    np.testing.assert_array_equal(base.result[1], want)

    same, rep, n = _run(img, hook=_once(lambda r, t: r.request_preempt()))
    assert same.n_preemptions == 1 and rep["host_spills_avoided"] == 1
    _check_counts(n, rep)

    def move(region, task):
        region.begin_drain()
        region.request_preempt()

    cross, rep, n = _run(img, n_regions=2, hook=_once(move))
    assert cross.n_preemptions == 1 and len(set(cross.region_history)) == 2
    _check_counts(n, rep)
    for t in (same, cross):
        for got, exp in zip(t.result, base.result):
            np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("engine", ["pipelined", "megakernel"])
def test_cuda_cluster_migration_is_bit_identical(cuda_device, engine):
    """Two shells on cuda:0 behind a ``ClusterFrontend``: a running task is
    checkpoint-migrated from shell 0 to shell 1 through the disk spill at
    its first chunk boundary (pipelined: ``on_chunk`` holds the worker
    there; megakernel: ``on_launch`` holds the M1 launch until the
    migrator's request has written the flag, so it exits after one chunk)
    and equals an unpreempted run bitwise.  Pipelined: every row block ran
    once through B1.  Megakernel: two M1 launches, no B1."""
    from repro_torch.cluster import ClusterFrontend

    img = make_image(np.random.default_rng(3), 200)
    base, _, _ = _run(img)
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1, chunk_budget=2,
                         prefetch=False, engine=engine)  # cuda:0 default
    kd = get_kernel("MedianBlur")
    task = Task(kernel="MedianBlur", args=kd.bundle(
        img.copy(), np.zeros_like(img), H=200, W=200, iters=3))
    reached = threading.Event()

    def hold(region, t):
        if t is task and not reached.is_set():
            reached.set()
            deadline = time.perf_counter() + TIMEOUT
            while (not region._preempt.is_set()
                   and time.perf_counter() < deadline):
                time.sleep(0.001)

    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = r.on_launch = hold
    try:
        before = (K.ROW_BLOCKS.total(), K.LAUNCHES.total(),
                  K.MEGA_LAUNCHES.total())
        h = fe.submit(task)
        assert reached.wait(TIMEOUT)
        assert fe.migrate(tid=task.tid)
        out = h.result(timeout=TIMEOUT)
        counts = (K.ROW_BLOCKS.total() - before[0],
                  K.LAUNCHES.total() - before[1],
                  K.MEGA_LAUNCHES.total() - before[2])
        assert h.n_migrations == 1 and h.node_history == [0, 1]
        src, dst = (n.shell.regions[0].stats for n in fe.nodes)
    finally:
        rep = fe.shutdown()
    assert rep["stranded_handles"] == 0 and rep["lost_tasks"] == 0
    assert rep["migrations_completed"] == 1
    if engine == "megakernel":
        assert counts[1:] == (0, 2) and src.flag_poll_exits == 1
    else:
        assert counts[0] == 3 * 8 and counts[2] == 0
    assert dst.host_spills_avoided == 0
    for got, exp in zip(out, base.result):
        np.testing.assert_array_equal(got, exp)


def test_cuda_pool_drain_resumes_on_a_grown_stream(cuda_device):
    """The elastic pool on the card: grow a second region (a second CUDA
    stream), drain the one running the task at its first chunk boundary;
    the task resumes on the grown stream from the retired region's bank
    and equals an unpreempted run bitwise, every row block once."""
    from repro_torch.core.pool import RegionPool
    from repro_torch.core.region import RegionState
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.core.shell import Shell

    img = make_image(np.random.default_rng(3), 200)  # pads to 256: 8 blocks
    base, _, _ = _run(img)
    shell = Shell(n_regions=1, chunk_budget=2)
    pool = RegionPool(shell, min_regions=1, max_regions=2)
    client = Client(backend=Scheduler(shell, pool=pool))
    grown = []

    def drain(region, task):
        pool.request_grow()
        deadline = time.perf_counter() + TIMEOUT
        while len(shell.regions) < 2 and time.perf_counter() < deadline:
            time.sleep(0.001)
        grown.append(shell.regions[-1])
        pool.request_shrink(region.rid)
        assert region._preempt.wait(TIMEOUT), "the drain never landed"

    try:
        shell.regions[0].on_chunk = _once(drain)
        kd = get_kernel("MedianBlur")
        task = Task(kernel="MedianBlur", args=kd.bundle(
            img.copy(), np.zeros_like(img), H=200, W=200, iters=3))
        before = (K.ROW_BLOCKS.total(), K.LAUNCHES.total())
        client.submit(task).result(timeout=TIMEOUT)
        counts = (K.ROW_BLOCKS.total() - before[0],
                  K.LAUNCHES.total() - before[1])
        rep = client.drain(TIMEOUT)
    finally:
        client.shutdown()
        shell.shutdown()
    first = shell.region(0)
    assert grown and grown[0].stream is not first.stream
    assert grown[0].device == first.device == cuda_device
    assert task.n_preemptions == 1 and task.region_history == [0, 1]
    assert first.state is RegionState.RETIRED and first.stream.query()
    assert (rep["pool"]["grows"], rep["pool"]["shrinks"]) == (1, 1)
    _check_counts(counts, rep)
    for got, exp in zip(task.result, base.result):
        np.testing.assert_array_equal(got, exp)


def test_cuda_retire_waits_for_the_regions_stream(cuda_device):
    """Retiring a region synchronises its stream first: work still queued
    there (a spin) has finished when ``retire`` returns."""
    from repro_torch.core.shell import Shell

    shell = Shell(n_regions=2)
    try:
        region = shell.regions[1]
        with torch.cuda.stream(region.stream):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning
        assert not region.stream.query()
        shell.retire_region(region.rid)
        assert region.stream.query() and not region.alive
        assert shell.region(region.rid) is region
        assert [r.rid for r in shell.regions] == [0]
    finally:
        shell.shutdown()


# -- attention kernels ---------------------------------------------------

def _randn(rng, shape, device, dtype=torch.float32):
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                        device=device).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("B,H,KV,T,S,hd,off,window", [
    (4, 32, 8, 16, 128, 128, 0, None),      # the serving prefill shape
    (4, 32, 8, 16, 128, 128, 64, None),
    (4, 32, 8, 16, 128, 128, 112, None),
    (2, 4, 2, 8, 32, 16, 24, None),         # the reference's q_offset sweep
    (2, 4, 4, 40, 40, 64, None, 7),         # ragged tiles, sliding window
    (1, 2, 1, 3, 5, 120, None, None),       # hd 120 (no lane padding)
    # the edges of the block plan and the staging: groups 1, 8 and 32 (16
    # heads a block), hd 16 and 120, a window at an offset, a ragged T
    # against a ragged S, hd 8 (one k-step), hd 30 (element staging: rows
    # not 16-byte aligned)
    (4, 32, 32, 16, 128, 128, 112, None),
    (4, 32, 4, 16, 128, 128, 112, None),
    (1, 32, 1, 16, 128, 128, 48, None),
    (4, 32, 8, 16, 128, 16, 64, None),
    (4, 32, 8, 16, 128, 120, 112, None),
    (4, 32, 8, 16, 128, 128, 96, 40),
    (2, 6, 2, 40, 70, 64, 30, None),
    (2, 8, 2, 16, 64, 8, 48, 9),
    (2, 4, 2, 16, 48, 30, 32, None),
    # passes of 128 keys: two, and a window that skips the first of three
    (1, 4, 4, 16, 260, 128, 240, None),
    (2, 8, 2, 16, 300, 64, 270, 100),
])
def test_cuda_flash_matches_plain_version(cuda_device, dtype, tol, B, H, KV,
                                          T, S, hd, off, window):
    rng = np.random.default_rng(T * S + hd)
    q = _randn(rng, (B, H, T, hd), cuda_device, dtype)
    k = _randn(rng, (B, KV, S, hd), cuda_device, dtype)
    v = _randn(rng, (B, KV, S, hd), cuda_device, dtype)
    before = FK.LAUNCHES["flash"]
    got = fops.flash_attention(q, k, v, causal=True, window=window,
                               q_offset=off)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash"] == before + 1
    want = fref.flash_attention(q, k, v, causal=True, window=window,
                                q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("B,H,KV,T,S,hd,off,window", [
    (4, 32, 8, 16, 300, 128, 0, None),      # three passes, keys past the rows
    (2, 8, 2, 16, 384, 64, 300, 150),       # a window that skips pass 0
])
def test_cuda_flash_non_causal_matches_plain_version(cuda_device, dtype, tol,
                                                     B, H, KV, T, S, hd, off,
                                                     window):
    """Without the causal mask a block takes every pass from its window's
    first key to S."""
    rng = np.random.default_rng(S + hd + off)
    q = _randn(rng, (B, H, T, hd), cuda_device, dtype)
    k = _randn(rng, (B, KV, S, hd), cuda_device, dtype)
    v = _randn(rng, (B, KV, S, hd), cuda_device, dtype)
    got = fops.flash_attention(q, k, v, causal=False, window=window,
                               q_offset=off)
    want = fref.flash_attention(q, k, v, causal=False, window=window,
                                q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_cuda_flash_takes_strided_cache_and_masks_to_zero(cuda_device):
    """The prefill passes k_new.transpose(1, 2) ([PB,P,KV,hd] storage); a
    row whose keys are all masked (window 0) outputs exactly 0."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 3, 4, 8), cuda_device).transpose(1, 2)  # strided
    k_new = _randn(rng, (2, 16, 2, 8), cuda_device)
    v_new = _randn(rng, (2, 16, 2, 8), cuda_device)
    got = fops.flash_attention(q, k_new.transpose(1, 2),
                               v_new.transpose(1, 2), q_offset=5)
    want = fref.flash_attention(q, k_new.transpose(1, 2),
                                v_new.transpose(1, 2), q_offset=5)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    dead = fops.flash_attention(q, k_new.transpose(1, 2),
                                v_new.transpose(1, 2), q_offset=5, window=0)
    assert bool((dead == 0).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("off", [0, 112])
def test_cuda_flash_unaligned_q_and_cache(cuda_device, dtype, tol, off):
    """The serving layout ([PB, C, H, hd] storage for q, [PB, P, KV, hd]
    for the cache), each view shifted by one element so no row starts
    16-byte aligned: q is read element by element and the cache is staged
    element by element."""
    rng = np.random.default_rng(off + 3)
    q_store = _randn(rng, (4 * 16 * 32 * 128 + 1,), cuda_device, dtype)
    q = q_store[1:].view(4, 16, 32, 128).transpose(1, 2)
    kv_store = _randn(rng, (2, 4 * 128 * 8 * 128 + 1), cuda_device, dtype)
    k, v = (kv_store[i, 1:].view(4, 128, 8, 128).transpose(1, 2)
            for i in range(2))
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    got = fops.flash_attention(q, k, v, q_offset=off)
    want = fref.flash_attention(q, k, v, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    dead = fops.flash_attention(q, k, v, q_offset=off, window=0)
    assert bool((dead == 0).all())


def _paged(rng, device, B=8, H=32, KV=8, hd=128, BS=16, T_blk=8, NB=65):
    k_pool = _randn(rng, (NB, BS, KV, hd), device)
    v_pool = _randn(rng, (NB, BS, KV, hd), device)
    ids = rng.permutation(np.arange(1, NB))[:B * T_blk]
    tables = torch.tensor(ids.reshape(B, T_blk).astype(np.int32),
                          device=device)
    q = _randn(rng, (B, H, 1, hd), device)
    return q, k_pool, v_pool, tables


# groups 1 / 4 / 8 at hd 128 and 64, then the edges of the kernel's design:
# a head dim that is not a multiple of 4 (4-byte loads) and one past a
# 128-dim tile (two output tiles)
DECODE_SHAPES = [(32, 8, 128), (32, 32, 128), (32, 4, 128), (32, 8, 64),
                 (32, 4, 64), (8, 4, 30), (8, 2, 200)]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("H,KV,hd", DECODE_SHAPES)
def test_cuda_decode_matches_plain_version(cuda_device, window, H, KV, hd):
    rng = np.random.default_rng(9 + H + KV + hd)
    q, k_pool, v_pool, tables = _paged(rng, cuda_device, H=H, KV=KV, hd=hd)
    pos = torch.tensor([0, 1, 17, 64, 100, 127, 128, 128], dtype=torch.int32,
                       device=cuda_device)
    before = DK.LAUNCHES.total()
    got = dops.paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                      window=window)
    torch.cuda.synchronize()
    assert DK.LAUNCHES["paged"] >= 1 and DK.LAUNCHES.total() == before + 1
    want = dref.paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                       window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)
    assert bool((got[0] == 0).all())  # pos = 0: no valid key
    # a ring that wrapped: pos past the cache length
    k_lin = dref.gather_kv_pages(k_pool, tables).contiguous()
    v_lin = dref.gather_kv_pages(v_pool, tables).contiguous()
    ring = torch.tensor([0, 5, 128, 129, 200, 255, 256, 1000],
                        dtype=torch.int32, device=cuda_device)
    got = dops.decode_attention(q, k_lin, v_lin, ring, window=window)
    want = dref.decode_attention(q, k_lin, v_lin, ring, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("H,KV,hd", DECODE_SHAPES)
def test_cuda_paged_bitwise_equals_gather_plus_contiguous(cuda_device, H, KV,
                                                          hd):
    rng = np.random.default_rng(10 + H + KV + hd)
    q, k_pool, v_pool, tables = _paged(rng, cuda_device, H=H, KV=KV, hd=hd)
    k_lin = dref.gather_kv_pages(k_pool, tables)
    v_lin = dref.gather_kv_pages(v_pool, tables)
    for pos in ([1, 9, 25, 33, 64, 80, 127, 128], 128,
                [0, 0, 3, 0, 7, 0, 9, 0]):
        p = (torch.tensor(pos, dtype=torch.int32, device=cuda_device)
             if isinstance(pos, list) else pos)
        paged = DK.launch_paged(q, k_pool, v_pool, tables, p, window=None,
                                scale=hd ** -0.5)
        dense = DK.launch(q, k_lin, v_lin, p, window=None, scale=hd ** -0.5)
        assert torch.equal(paged, dense)
        want = dref.decode_attention(q, k_lin, v_lin, p, scale=hd ** -0.5)
        torch.testing.assert_close(paged, want, rtol=0, atol=F32_TOL)


def test_cuda_attention_wrappers_reject_bad_inputs(cuda_device):
    rng = np.random.default_rng(11)
    q = _randn(rng, (1, 4, 8, 16), cuda_device)
    k = _randn(rng, (1, 2, 8, 16), cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        FK.launch(q.cpu(), k, k, causal=True, window=None, q_offset=0,
                  scale=0.25)
    with pytest.raises(TypeError):
        FK.launch(q.double(), k.double(), k.double(), causal=True,
                  window=None, q_offset=0, scale=0.25)
    with pytest.raises(TypeError):
        FK.launch(q, k.bfloat16(), k, causal=True, window=None, q_offset=0,
                  scale=0.25)
    with pytest.raises(ValueError, match="KV"):
        FK.launch(q, k[:, :, :, :8], k, causal=True, window=None, q_offset=0,
                  scale=0.25)
    with pytest.raises(ValueError, match="head dim"):
        FK.launch(q.transpose(2, 3).contiguous().transpose(2, 3), k, k,
                  causal=True, window=None, q_offset=0, scale=0.25)
    qd, k_pool, v_pool, tables = _paged(rng, cuda_device, B=2, H=4, KV=2,
                                        hd=16, BS=4, T_blk=3, NB=8)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        DK.launch_paged(qd, k_pool, v_pool, tables.cpu(), pos, window=None,
                        scale=0.25)
    with pytest.raises(TypeError):
        DK.launch_paged(qd.bfloat16(), k_pool, v_pool, tables, pos,
                        window=None, scale=0.25)
    with pytest.raises(TypeError):
        DK.launch_paged(qd, k_pool, v_pool, tables.long(), pos, window=None,
                        scale=0.25)
    with pytest.raises(ValueError, match="rows"):
        DK.launch_paged(qd, k_pool, v_pool, tables[:1], pos, window=None,
                        scale=0.25)
    with pytest.raises(ValueError, match=r"\[B,H,1,hd\]"):
        DK.launch(q, k, k, 3, window=None, scale=0.25)


# -- device results and stream ordering ------------------------------------

def test_cuda_device_result_is_read_after_its_producer(cuda_device):
    """A region uploads a device tensor on its own stream only after the
    producer's event: the producer stream sleeps before writing, so a read
    that did not wait would see the old zeros."""
    client = Client(n_regions=1)
    try:
        region = client.shell.regions[0]
        producer = torch.cuda.Stream()
        src = torch.zeros(1 << 20, device=cuda_device)
        torch.cuda.synchronize()
        with torch.cuda.stream(producer):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning
            src.fill_(1.0)
            ev = torch.cuda.Event()
            ev.record(producer)
        mark_ready([src], ev)
        with torch.cuda.stream(region.stream):
            copy = region._upload(src)
        region.stream.synchronize()
        assert bool((copy == 1.0).all())
    finally:
        client.shutdown()


def test_cuda_device_result_tasks_return_device_tensors(cuda_device):
    kd = get_kernel("SeqPrefill")
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :3] = [7, 1, 7]
    bundle = kd.bundle(np.zeros((1, 8), np.int32),
                       np.zeros((1, 32), np.int32), prompt, P=16, D=32,
                       vocab=257, prompt_len=3)
    with Client(n_regions=1) as client:
        out = client.submit(Task(kernel="SeqPrefill", args=bundle)).result(
            timeout=TIMEOUT)
    assert all(isinstance(b, torch.Tensor) and b.is_cuda for b in out)


def test_cuda_client_stream_attention_with_forced_preemption(cuda_device):
    """Client.stream on cuda:0 through both hand-written kernels, with the
    first decode round preempted at its 2nd chunk: every stream equals the
    oracle replayed on the card with the LM's own weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    p = AttentionParams()
    serving = {"lm": "attention", "d_model": p.d_model,
               "vocab_size": p.vocab, "max_slots": 3, "round_tokens": 4,
               "decode_regions": (1,), "prefill_regions": (0,)}
    chunks = {}

    def hook(region, task):
        if task.phase != "decode" or chunks.get("preempted"):
            return
        chunks[task.tid] = chunks.get(task.tid, 0) + 1
        if chunks[task.tid] == 2:
            chunks["preempted"] = True
            region.request_preempt()

    with Client(n_regions=2, chunk_budget=1, serving=serving) as client:
        for r in client.shell.regions:
            r.on_chunk = hook
        rng = np.random.default_rng(3)
        prompts = [[int(x) for x in rng.integers(0, p.vocab, size=n)]
                   for n in (3, 9, 20)]
        handles = [client.stream(pr, max_new_tokens=8) for pr in prompts]
        got = [h.result(timeout=TIMEOUT) for h in handles]
        weights = client.serving.lm.weights
        rep = client.serving_report()
        modes = {r["kernel_mode"] for r in
                 client.shell.reconfig_report()["regions"].values()}
    for pr, toks in zip(prompts, got):
        assert toks == attention_oracle_stream(pr, 8, p, max_slots=3,
                                               round_tokens=4,
                                               weights=weights)
    assert rep["decode_preemptions"] >= 1 and rep["n_finished"] == 3
    assert modes == {"cuda"}


# -- recurrence kernels (B4, B5) and serve lm ---------------------------------

@pytest.mark.parametrize("B,T,L,kind", [
    (2, 64, 200, "sigmoid"), (1, 128, 128, "sigmoid"), (3, 33, 100, "sigmoid"),
    (4, 128, 4096, "sigmoid"), (4, 1, 4096, "sigmoid"),
    (2, 1, 100, "sigmoid"), (2, 2, 100, "sigmoid"), (2, 17, 100, "sigmoid"),
    (2, 129, 4096, "sigmoid"), (1, 2048, 100, "sigmoid"),
    (2, 2048, 4096, "sigmoid"), (2, 17, 4096, "0/1"), (2, 129, 100, "0/1"),
    (2, 129, 4096, "strided"), (2, 17, 100, "strided")])
def test_cuda_rglru_scan_matches_plain_version(cuda_device, B, T, L, kind):
    """The reference's sweep shapes, the serving prefill and decode shapes
    of recurrentgemma-9b, and the edges of the kernel's segments and time
    tiles (T 1, 2, 17, 129, 2048) and of its channel stripes (L 100, with
    one thread a channel; L 4096, one float4 a thread): gates a = 0 and
    a = 1 exactly among the others ("0/1"), and a, b read in place from
    wider rows ("strided": float4 where L allows, misaligned otherwise);
    with a nonzero h0 and without one."""
    rng = np.random.default_rng(B * T + L)
    a = torch.sigmoid(_randn(rng, (B, T, L), cuda_device))
    b = _randn(rng, (B, T, L), cuda_device)
    if kind == "0/1":
        pick = torch.tensor(rng.random((B, T, L)), device=cuda_device)
        a = torch.where(pick < 0.25, 0.0, torch.where(pick < 0.5, 1.0, a))
    elif kind == "strided":
        off = 0 if L % 4 == 0 else 1
        wide_a = torch.sigmoid(_randn(rng, (B, T, L + 8), cuda_device))
        a, b = wide_a[..., off:off + L], _randn(
            rng, (B, T, L + 8), cuda_device)[..., off:off + L]
        assert GK.vector_width(a, b) == (4 if off == 0 else 1)
    h0 = _randn(rng, (B, L), cuda_device)
    for init in (h0, None):
        before = GK.LAUNCHES["rglru"]
        hs, h_last = gops.rglru_scan(a, b, init)
        torch.cuda.synchronize()
        assert GK.LAUNCHES["rglru"] == before + 1
        want_hs, want_last = gref.rglru_scan(a, b, init)
        torch.testing.assert_close(hs, want_hs, rtol=0, atol=SCAN_TOL)
        torch.testing.assert_close(h_last, want_last, rtol=0, atol=SCAN_TOL)


@pytest.mark.parametrize("B,T,H,hd,decay", [
    (2, 48, 3, 16, "random"), (1, 64, 2, 32, "random"), (2, 17, 4, 8, "random"),
    (4, 128, 32, 64, "random"), (4, 1, 32, 64, "random"),
    (1, 5, 2, 40, "random"), (2, 1, 4, 64, "random"), (2, 15, 4, 64, "random"),
    (2, 16, 4, 64, "random"), (2, 17, 4, 64, "random"),
    (2, 33, 3, 64, "random"), (1, 300, 2, 64, "random"),
    (2, 33, 2, 8, "random"), (2, 33, 2, 16, "random"),
    (2, 33, 2, 40, "random"), (2, 33, 2, 64, "w=0"), (2, 33, 2, 64, "w=1")])
def test_cuda_rwkv6_matches_plain_version(cuda_device, B, T, H, hd, decay):
    """The reference's sweep shapes, rwkv6-1.6b's serving prefill and
    decode shapes, the edges of the kernel's 16-step chunks (T 1, 15, 16,
    17, 33, 300) and of its 16-column blocks (hd 8, 16, 40, 64; 40 is no
    power of two), and the extreme decays logw = -80 (w about 0) and
    logw = 0 (w = 1); with a nonzero s0 and without one, the inputs
    strided as the projections leave them."""
    rng = np.random.default_rng(B * T + H * hd)
    r, k, v = (_randn(rng, (B, T, H * hd), cuda_device).view(B, T, H, hd)
               for _ in range(3))
    logw = -torch.exp(_randn(rng, (B, T, H, hd), cuda_device) * 0.5 - 1)
    if decay != "random":
        logw = torch.full_like(logw, -80.0 if decay == "w=0" else 0.0)
    u = _randn(rng, (H, hd), cuda_device) * 0.1
    s0 = _randn(rng, (B, H, hd, hd), cuda_device) * 0.5
    for init in (s0, None):
        before = WK.LAUNCHES["rwkv6"]
        o, s_last = wops.rwkv6(r, k, v, logw, u, init)
        torch.cuda.synchronize()
        assert WK.LAUNCHES["rwkv6"] == before + 1
        want_o, want_s = wref.rwkv6(r, k, v, logw, u, init)
        torch.testing.assert_close(o, want_o, rtol=0, atol=RWKV_TOL)
        torch.testing.assert_close(s_last, want_s, rtol=0, atol=RWKV_TOL)


def test_cuda_recurrence_wrappers_reject_bad_inputs(cuda_device):
    rng = np.random.default_rng(12)
    a = _randn(rng, (2, 5, 40), cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        GK.launch(a.cpu(), a.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        GK.launch(a, a, torch.zeros(2, 40))
    with pytest.raises(TypeError):
        GK.launch(a.double(), a.double())
    with pytest.raises(ValueError, match="unit stride"):
        GK.launch(a.transpose(1, 2).contiguous().transpose(1, 2), a)
    r = _randn(rng, (1, 4, 2, 8), cuda_device)
    u = _randn(rng, (2, 8), cuda_device)
    with pytest.raises(ValueError, match="CUDA"):
        WK.launch(r.cpu(), r, r, r, u)
    with pytest.raises(ValueError, match="CUDA"):
        WK.launch(r, r, r, r, u.cpu())
    big = _randn(rng, (1, 2, 1, 80), cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        WK.launch(big, big, big, big, _randn(rng, (1, 80), cuda_device))
    with gops.plain_versions():  # the override launches nothing
        before = (GK.LAUNCHES.total(), WK.LAUNCHES.total())
        gops.rglru_scan(a, a)
        wops.rwkv6(r, r, r, -r.abs(), u)
        assert (GK.LAUNCHES.total(), WK.LAUNCHES.total()) == before


@pytest.mark.parametrize("arch,per_step", [("rwkv6-1.6b", {"rwkv6": 2}),
                                           ("recurrentgemma-9b",
                                            {"rglru": 4})])
def test_cuda_serve_lm_reduced_matches_cpu(cuda_device, arch, per_step):
    """``serve lm`` on cuda:0 (the default) at reduced width: the same
    tokens as the plain path on the card, exact launch counts (one per
    recurrent layer per step), and the same tokens as the CPU path on the
    same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    gen, batch, T = 6, 2, 24
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                (batch, T)).astype(np.int32)
    GK.LAUNCHES.reset()
    WK.LAUNCHES.reset()
    toks = S.serve(cfg, batch=batch, prompt_len=T, gen=gen, prompts=prompts)
    assert {"rglru": GK.LAUNCHES["rglru"], "rwkv6": WK.LAUNCHES["rwkv6"]} == {
        "rglru": per_step.get("rglru", 0) * gen,
        "rwkv6": per_step.get("rwkv6", 0) * gen}
    params, _, _ = S.draw(cfg, batch=batch, prompt_len=T, seed=0,
                          device=cuda_device)
    with gops.plain_versions():
        plain = S.generate(params, torch.tensor(prompts, device=cuda_device),
                           cfg, gen=gen)
    np.testing.assert_array_equal(toks, plain["tokens"])
    cpu = S.generate(_to_cpu(params), torch.tensor(prompts), cfg, gen=gen)
    np.testing.assert_array_equal(toks, cpu["tokens"])


def test_cuda_serve_whisper_reduced_matches_cpu(cuda_device):
    """``serve lm --arch whisper-tiny --reduced`` on cuda:0 (the encoder,
    the cross-attention, the ``enc`` cache): the same tokens as the CPU
    run on the same weights, frames and prompts, and prefill logits
    within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny").reduced()
    gen, batch, T = 6, 2, 8
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                (batch, T)).astype(np.int32)
    frames = np.random.default_rng(6).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    toks = S.serve(cfg, batch=batch, prompt_len=T, gen=gen, prompts=prompts,
                   frontend=frames, quiet=True)
    params, _, _ = S.draw(cfg, batch=batch, prompt_len=T, seed=0,
                          device=cuda_device)
    card = S.generate(params, torch.tensor(prompts, device=cuda_device), cfg,
                      gen=gen, frontend=torch.tensor(frames,
                                                     device=cuda_device))
    cpu = S.generate(_to_cpu(params), torch.tensor(prompts), cfg, gen=gen,
                     frontend=torch.tensor(frames))
    np.testing.assert_array_equal(toks, card["tokens"])
    np.testing.assert_array_equal(toks, cpu["tokens"])
    torch.testing.assert_close(card["logits"].cpu(), cpu["logits"], rtol=0,
                               atol=1e-4)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# -- M2/M3, the persistent surrogate-LM kernels -------------------------------

def _seq_inputs(kernel, dev, d_model, vocab, seed=0, prompt_len=7,
                slots=4, steps=5):
    """One task's buffers on the card for ``kernel`` (two equal sets: the
    kernel's and the plain version's) and its scalars: a padded prompt for
    ``SeqPrefill``; for ``SeqDecode`` slot rows of every kind (live, fewer
    tokens than the round, inactive, none)."""
    from repro_torch.serving.kernels import init_state

    rng = np.random.default_rng(seed)
    if kernel == "SeqPrefill":
        P = -(-prompt_len // 16) * 16
        prompt = np.zeros((1, P), np.int32)
        prompt[0, :prompt_len] = rng.integers(0, vocab, prompt_len)
        bufs = (np.zeros((1, 8), np.int32), init_state(seed, d_model)[None],
                prompt)
        scalars = dict(P=P, D=d_model, vocab=vocab, prompt_len=prompt_len)
    else:
        state = rng.integers(-2**31, 2**31, (slots, d_model),
                             dtype=np.int64).astype(np.int32)
        tbl = np.zeros((slots, 8), np.int32)
        tbl[:, 0] = rng.integers(0, 2, slots)
        tbl[:, 0][:2] = 1
        tbl[:, 1] = rng.integers(0, steps + 1, slots)
        tbl[:, 1][0] = steps
        tbl[:, 2] = rng.integers(0, vocab, slots)
        bufs = (np.full((slots, steps), -1, np.int32), state, tbl)
        scalars = dict(S=slots, D=d_model, R=steps, vocab=vocab)
    mine = tuple(torch.tensor(b, device=dev) for b in bufs)
    return mine, tuple(b.clone() for b in mine), scalars


def _seq_step(kernel, mine, plain, scalars, ctx, budget, flag, boundary):
    """One launch of M2/M3 and of its plain version (the host loop over
    the task body, on the card) from ``ctx`` with the flag at
    ``boundary``: equal context words, chunk counts, progress and
    buffers, bitwise.  Returns the context after it."""
    from repro_torch.kernels.seq_lm import kernel as QK

    kd = get_kernel(kernel)
    flag.write(boundary)
    launches = QK.MEGA_LAUNCHES[kernel]
    if kernel == "SeqPrefill":
        launch = QK.seq_prefill_mega(ctx.to_words(), *mine,
                                     scalars["prompt_len"], scalars["vocab"],
                                     budget, flag)
    else:
        launch = QK.seq_decode_mega(ctx.to_words(), *mine, scalars["vocab"],
                                    budget, flag)
    words, n = launch.result()
    assert QK.MEGA_LAUNCHES[kernel] == launches + 1
    assert flag.progress() == n
    _, ints, floats = kd.bundle(*mine, **scalars).padded()
    want, _, want_n = make_megakernel(kd)(ctx, plain, ints, floats, budget,
                                          flag).result()
    torch.cuda.synchronize()
    assert n == want_n
    np.testing.assert_array_equal(words, want.to_words())
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    flag.clear()
    return want


@pytest.mark.parametrize("kernel", ["SeqPrefill", "SeqDecode"])
@pytest.mark.parametrize("budget", [1, 2, 4])
@pytest.mark.parametrize("d_model,vocab,size", [(16, 101, 3),
                                                (384, 51865, 32),
                                                (100, 51865, 130),
                                                (1000, 51865, 56),
                                                (1000, 51865, 128),
                                                (60000, 101, 5)])
def test_cuda_seq_mega_matches_plain_version(cuda_device, kernel, budget,
                                             d_model, vocab, size):
    """M2/M3 against their plain versions on the card: a whole task in one
    launch, then the flag at every boundary of a fresh task and its
    resume.  ``size`` is the prompt length (M2) or the slot rows (M3;
    130 is cut to 128, the most one launch takes: 32 warps of 4 rows).
    d_model 1000 puts M3's 56 rows in shared memory and its 128 rows over
    the residency cap, in global memory; 60000 puts M2's one row there."""
    from repro_torch.kernels.seq_lm import kernel as QK

    if kernel == "SeqDecode":
        size = min(size, QK.MAX_SLOTS)
        kw = dict(slots=size, steps=6)
        steps = 6
    else:
        kw = dict(prompt_len=size)
        steps = size
    flag = PreemptFlag(cuda_device)
    mine, plain, scalars = _seq_inputs(kernel, cuda_device, d_model, vocab,
                                       seed=budget, **kw)
    ctx = _seq_step(kernel, mine, plain, scalars, ContextRecord.fresh(),
                    budget, flag, 0)
    assert ctx.done == 1
    for k in range(1, -(-steps // budget) + 1):
        mine, plain, scalars = _seq_inputs(kernel, cuda_device, d_model,
                                           vocab, seed=k, **kw)
        ctx = ContextRecord.fresh()
        while not ctx.done:
            ctx = _seq_step(kernel, mine, plain, scalars, ctx, budget, flag,
                            k)


@pytest.mark.parametrize("kernel", ["SeqPrefill", "SeqDecode"])
def test_cuda_seq_mega_flag_write_lag(cuda_device, kernel):
    """A flag written into a running M2/M3 launch at budget 1 stops it at
    most 2 chunks past the progress the host read right after the write,
    and the buffers and context words then equal the plain version's
    stopped at that boundary."""
    from repro_torch.kernels.seq_lm import kernel as QK

    steps, at_least = 100_000, 200
    kw = (dict(prompt_len=steps) if kernel == "SeqPrefill" else
          dict(slots=32, steps=steps))
    flag = PreemptFlag(cuda_device)
    mine, plain, scalars = _seq_inputs(kernel, cuda_device, 384, 51865,
                                       seed=11, **kw)
    if kernel == "SeqDecode":
        for t in (mine[2], plain[2]):  # every row live all along
            t[:, 0], t[:, 1] = 1, steps
    ctx = ContextRecord.fresh()
    if kernel == "SeqPrefill":
        launch = QK.seq_prefill_mega(ctx.to_words(), *mine, steps,
                                     scalars["vocab"], 1, flag)
    else:
        launch = QK.seq_decode_mega(ctx.to_words(), *mine, scalars["vocab"],
                                    1, flag)
    deadline = time.perf_counter() + TIMEOUT
    while flag.progress() < at_least:
        assert time.perf_counter() < deadline and not launch.query()
    flag.write(1)
    at = flag.progress()
    words, n = launch.result()
    assert 0 <= n - at <= 2, (n, at)
    assert n < steps and flag.progress() == n
    flag.write(n)
    kd = get_kernel(kernel)
    _, ints, floats = kd.bundle(*plain, **scalars).padded()
    want, _, want_n = make_megakernel(kd)(ctx, plain, ints, floats, 1,
                                          flag).result()
    torch.cuda.synchronize()
    assert want_n == n
    np.testing.assert_array_equal(words, want.to_words())
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)
    flag.clear()


def test_cuda_seq_mega_wrappers_reject_bad_inputs(cuda_device):
    from repro_torch.kernels.seq_lm import kernel as QK

    flag = PreemptFlag(cuda_device)
    words = ContextRecord.fresh().to_words()
    (out, state, prompt), _, _ = _seq_inputs("SeqPrefill", cuda_device, 16,
                                             101)
    with pytest.raises(ValueError, match="prompt_len"):
        QK.seq_prefill_mega(words, out, state, prompt, 17, 101, 1, flag)
    with pytest.raises(TypeError):
        QK.seq_prefill_mega(words, out, state.long(), prompt, 7, 101, 1,
                            flag)
    with pytest.raises(ValueError, match="budget"):
        QK.seq_prefill_mega(words, out, state, prompt, 7, 101, 0, flag)
    with pytest.raises(ValueError, match="PreemptFlag"):
        QK.seq_prefill_mega(words, out, state, prompt, 7, 101, 1,
                            PreemptFlag())
    (out, state, slots), _, _ = _seq_inputs("SeqDecode", cuda_device, 16,
                                            101)
    with pytest.raises(ValueError, match="context words"):
        QK.seq_decode_mega(words[:35], out, state, slots, 101, 1, flag)
    with pytest.raises(ValueError, match="slots"):
        QK.seq_decode_mega(words, out, state, slots[:, :3], 101, 1, flag)
    with pytest.raises(ValueError, match="CUDA"):
        QK.seq_decode_mega(words, out.cpu(), state, slots, 101, 1, flag)


@pytest.mark.parametrize("warps", [1, 32])
def test_cuda_seq_latency_probe(cuda_device, warps):
    """``seq_latency_probe`` (the latencies of M2/M3's serial chain) on
    the card: every step takes at least a cycle a repetition, a chunk
    boundary at least its flag read, a barrier and a shuffle-add pair more
    than an add; the earlier design's whole chunk at least its chunk
    without the boundary and at least its boundary, that at least its
    control; a flag read with a step under it more than the step (the
    read, relaxed or acquire, more than a dependent add); and no launch
    counter moves."""
    from repro_torch.kernels.seq_lm import kernel as QK

    flag = PreemptFlag(cuda_device)
    before = QK.MEGA_LAUNCHES.total()
    got = QK.latency_probe(flag, 384, 51865, warps, reps=256)
    assert set(got) == set(QK.PROBE_STEPS) | {"ns_per_cycle"}
    assert len(QK.PROBE_STEPS) == 21
    assert all(got[k] >= 1.0 for k in QK.PROBE_STEPS), got
    assert got["boundary"] >= got["flag_read"] > got["iadd"]
    assert got["shfl_add"] > got["iadd"]
    assert got["parent_chunk"] >= got["parent_chunk_noflag"]
    assert got["parent_chunk"] >= got["boundary"]
    assert got["parent_chunk_noflag"] >= got["parent_control"]
    assert got["flag_overlap"] > got["m2_step_resident"]
    assert got["flag_relaxed"] > got["iadd"]
    assert got["device_read"] > got["iadd"]
    assert got["bar_after_read"] >= got["bar_sync"]
    assert got["m3_chunk_under_read"] > got["iadd"]
    assert 0.1 < got["ns_per_cycle"] < 2.0
    assert QK.MEGA_LAUNCHES.total() == before
    with pytest.raises(ValueError, match="warps"):
        QK.latency_probe(flag, 384, 51865, 33)
    with pytest.raises(ValueError, match="PreemptFlag"):
        QK.latency_probe(PreemptFlag(), 384, 51865, 1)


@pytest.mark.parametrize("engine", ["pipelined", "megakernel"])
def test_cuda_serve_decode_streams_equal_oracle(cuda_device, engine):
    """``serve decode`` on cuda:0 (the default), a probe every 2nd round:
    every stream verifies against the oracle.  In megakernel mode every
    prefill and round is one launch of M2/M3 (counted), rounds exit on
    the flag, and nothing runs the host loop."""
    from repro_torch.kernels.seq_lm import kernel as QK

    QK.MEGA_LAUNCHES.reset()
    rep = S.serve_decode(n_sequences=8, prompt_len=12, max_new=12, slots=4,
                         round_tokens=4, preempt_every=2, engine=engine,
                         quiet=True)
    assert rep["n_finished"] == 8
    launches = (QK.MEGA_LAUNCHES["SeqPrefill"], QK.MEGA_LAUNCHES["SeqDecode"])
    if engine == "megakernel":
        assert rep["decode_preemptions"] >= 1
        assert launches[0] == rep["prefill_tasks"]
        assert launches[1] == rep["decode_rounds"] + rep["decode_preemptions"]
    else:
        assert launches == (0, 0)


def test_cuda_serve_decode_attention_megakernel_streams_equal_oracle(
        cuda_device, monkeypatch):
    """``serve decode --lm attention --engine megakernel`` on cuda:0, a
    probe every 2nd round: every stream verifies against
    ``attention_oracle_stream`` inside ``serve_decode``; every prefill and
    round is one launch of M4/M5, rounds exit on the flag, and neither B2
    nor B3 is launched on the way: their counts, read when the first
    oracle replay starts (after the last stream is done), are 0, and the
    replays, which go through the chunk path, launch both."""
    from repro_torch.kernels.attn_lm import kernel as AK
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.serving import attention as A

    oracle, at_replay, replays = A.attention_oracle_stream, [], []

    def counted_oracle(*args, **kwargs):
        if not at_replay:
            at_replay.append((FK.LAUNCHES.total(), DK.LAUNCHES.total()))
        replays.append(1)
        return oracle(*args, **kwargs)

    monkeypatch.setattr(A, "attention_oracle_stream", counted_oracle)
    for counter in (AK.MEGA_LAUNCHES, FK.LAUNCHES, DK.LAUNCHES):
        counter.reset()
    rep = S.serve_decode(n_sequences=6, prompt_len=12, max_new=12, slots=4,
                         round_tokens=4, preempt_every=2, lm="attention",
                         engine="megakernel", quiet=True)
    assert rep["n_finished"] == 6 and rep["decode_preemptions"] >= 1
    assert len(replays) == 6 and at_replay == [(0, 0)]
    assert FK.LAUNCHES.total() > 0 and DK.LAUNCHES.total() > 0
    assert AK.MEGA_LAUNCHES["AttnPrefill"] == rep["prefill_tasks"]
    assert AK.MEGA_LAUNCHES["AttnDecode"] == (rep["decode_rounds"]
                                              + rep["decode_preemptions"])


# -- M4/M5, the attention LM's persistent entries ----------------------------
# the default geometry, and one with B2/B3's other plans: a group of 8
# (heads a block 8), hd 64, 4 keys a warp step, 2 prefill segments
ATTN_GEOMETRIES = (AttentionParams(),
                   AttentionParams(d_model=256, vocab=1000, n_heads=16,
                                   kv_heads=2, head_dim=64, block_size=16,
                                   max_ctx=32, seed=5))


def _attn_inputs(kind, dev, p, seed, PB=3, S=5, R=5, lens=None):
    """One attention-LM task's buffers on the card (two sets, the weights
    shared) and its scalars: ``PB`` prompts of 1 to ``max_ctx`` tokens (or
    of the lengths ``lens``), or ``S`` slot rows of an ``R``-step round
    (row 0 live all round, row 1 dead, the others at random) over shuffled
    pages."""
    from repro_torch.serving import attention as A

    rng = np.random.default_rng(seed)
    if kind == "prefill":
        PB = len(lens) if lens else PB
        prompt = np.zeros((PB, p.max_ctx), np.int32)
        meta = np.zeros((PB, A.META_W), np.int32)
        for r in range(PB):
            n = lens[r] if lens else int(rng.integers(1, p.max_ctx + 1))
            prompt[r, :n] = rng.integers(0, p.vocab, n)
            meta[r, 0] = n
        kv = np.zeros((PB, p.max_ctx, p.kv_heads, p.head_dim), np.float32)
        bufs = (np.full((PB, A.PREFILL_OUT_W), -1, np.int32), kv, kv.copy(),
                prompt, meta)
        scalars = dict(PB=PB, P=p.max_ctx, vocab=p.vocab)
    else:
        NB = S * p.blocks_per_seq + 1
        shape = (NB, p.block_size, p.kv_heads, p.head_dim)
        k_pool = rng.standard_normal(shape).astype(np.float32)
        v_pool = rng.standard_normal(shape).astype(np.float32)
        k_pool[0] = v_pool[0] = 0.0
        table = np.zeros((S, p.table_width), np.int32)
        pages = rng.permutation(np.arange(1, NB))
        for s in range(S):
            pos = int(rng.integers(1, p.max_ctx - R))
            table[s, 0] = (1, 0)[s] if s < 2 else int(rng.integers(0, 2))
            table[s, 1] = R if s == 0 else int(rng.integers(0, R + 1))
            table[s, 2] = int(rng.integers(0, p.vocab))
            table[s, A.COL_SEQ_LEN] = pos
            n_blk = -(-(pos + R) // p.block_size)
            table[s, A.TABLE_META:A.TABLE_META + n_blk] = pages[
                s * p.blocks_per_seq:s * p.blocks_per_seq + n_blk]
        bufs = (np.full((S, R), -1, np.int32), k_pool, v_pool, table)
        scalars = dict(S=S, R=R, vocab=p.vocab)
    w = A.load_weights(A.build_weights(p), dev)
    mine = tuple(torch.tensor(b, device=dev) for b in bufs) + (w,)
    return mine, tuple(b.clone() for b in mine[:-1]) + (w,), scalars


def _attn_step(kind, p, mine, plain, scalars, ctx, budget, flag, boundary):
    """One launch of M4/M5 and of its plain version (the host loop over the
    chunk body, on the card) from ``ctx`` with the flag at ``boundary``:
    equal context words, chunk counts and progress, tokens and tables
    bitwise, K/V within 2e-5.  Returns the context after it."""
    from repro_torch.kernels.attn_lm import kernel as AK
    from repro_torch.serving import attention as A

    names = A.register_attention_kernels(p)
    name = names[0] if kind == "prefill" else names[1]
    kd = get_kernel(name)
    flag.write(boundary)
    key = "AttnPrefill" if kind == "prefill" else "AttnDecode"
    launches = AK.MEGA_LAUNCHES[key]
    launch = (AK.attn_prefill_mega(ctx.to_words(), *mine, p.geometry(),
                                   budget, flag) if kind == "prefill" else
              AK.attn_decode_mega(ctx.to_words(), *mine, p.geometry(),
                                  budget, flag))
    words, n = launch.result()
    assert AK.MEGA_LAUNCHES[key] == launches + 1
    assert flag.progress() == n
    _, ints, floats = kd.bundle(*plain, **scalars).padded()
    want, _, want_n = make_megakernel(kd)(ctx, plain, ints, floats, budget,
                                          flag).result()
    torch.cuda.synchronize()
    assert n == want_n
    np.testing.assert_array_equal(words, want.to_words())
    for a, b in zip(mine[:-1], plain[:-1]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=F32_TOL)
    flag.clear()
    return want


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("budget", [1, 2, 4, 8])
@pytest.mark.parametrize("p", ATTN_GEOMETRIES, ids=["default", "group8"])
def test_cuda_attn_mega_matches_plain_version(cuda_device, kind, budget, p):
    """M4/M5 against their plain versions on the card: a whole task in one
    launch, then the flag at every boundary of a fresh task and its
    resume.  At budget 8 M4's one chunk (192 rows at the default
    geometry) takes two passes of its projections."""
    steps = p.max_ctx // p.block_size if kind == "prefill" else 5
    flag = PreemptFlag(cuda_device)
    mine, plain, sc = _attn_inputs(kind, cuda_device, p, seed=budget)
    ctx = _attn_step(kind, p, mine, plain, sc, ContextRecord.fresh(), budget,
                     flag, 0)
    assert ctx.done == 1
    for k in range(1, -(-steps // budget) + 1):
        mine, plain, sc = _attn_inputs(kind, cuda_device, p, seed=k)
        ctx = ContextRecord.fresh()
        while not ctx.done:
            ctx = _attn_step(kind, p, mine, plain, sc, ctx, budget, flag, k)


@pytest.mark.parametrize("budget", [1, 2, 8])
@pytest.mark.parametrize("lens,chunks", [((3, 5, 9, 16), 1),
                                         ((5, 20, 40, 60), 4)],
                         ids=["one_chunk", "four_chunks"])
def test_cuda_attn_prefill_emitting_rows_across_chunks(cuda_device, lens,
                                                       chunks, budget):
    """M4 reads Wo and E at a chunk's end for every row that emits in it: a
    4-row prefill at the default geometry (8 segments of 8 positions)
    whose rows emit in one chunk of budget 2, and one whose rows emit in
    four, against the plain version at every flag boundary."""
    p = ATTN_GEOMETRIES[0]
    C = p.block_size * 2
    assert len({(n - 1) // C for n in lens}) == chunks
    flag = PreemptFlag(cuda_device)
    steps = p.max_ctx // p.block_size
    for k in range(0, -(-steps // budget) + 1):
        mine, plain, sc = _attn_inputs("prefill", cuda_device, p, seed=k,
                                       lens=lens)
        ctx = ContextRecord.fresh()
        while not ctx.done:
            ctx = _attn_step("prefill", p, mine, plain, sc, ctx, budget,
                             flag, k)
        assert (mine[0][:, 0] >= 0).all()  # every row emitted


def test_cuda_attn_workspace_holds_a_chunk(cuda_device):
    """``attn_lm_workspace`` (the size ``_workspace`` allocates) at M4's
    chunk rows (``prefill_rows``) grows with the budget up to one chunk of
    every segment and holds x, q and o for each of those rows."""
    from repro_torch.kernels.attn_lm import kernel as AK

    lib = AK._lib()
    for p in ATTN_GEOMETRIES + (AttentionParams(
            d_model=4096, vocab=151936, n_heads=32, kv_heads=8,
            head_dim=128, block_size=16, max_ctx=128),):
        g = p.geometry()
        HQ = g.n_heads * g.head_dim
        sizes = []
        for b in range(1, 9):
            rows = AK.prefill_rows(4, g, b)
            n = lib.attn_lm_workspace(rows, 4, g.d_model, g.n_heads,
                                      g.head_dim)
            assert n >= rows * (g.d_model + 2 * HQ)
            assert AK._workspace(rows, 4, g, cuda_device).numel() == n
            sizes.append(n)
        assert sizes == sorted(sizes)
        assert len(set(sizes)) == min(8, g.max_ctx // g.block_size)


def test_cuda_attn_mega_wrappers_reject_bad_inputs(cuda_device):
    from repro_torch.kernels.attn_lm import kernel as AK

    p = AttentionParams()
    g = p.geometry()
    flag = PreemptFlag(cuda_device)
    words = ContextRecord.fresh().to_words()
    mine, _, _ = _attn_inputs("prefill", cuda_device, p, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        AK.attn_prefill_mega(words, *mine, g._replace(head_dim=132), 1, flag)
    with pytest.raises(ValueError, match="head dim"):
        AK.attn_prefill_mega(words, *mine, g._replace(head_dim=18), 1, flag)
    with pytest.raises(ValueError, match="budget"):
        AK.attn_prefill_mega(words, *mine, g, 0, flag)
    with pytest.raises(ValueError, match="PreemptFlag"):
        AK.attn_prefill_mega(words, *mine, g, 1, PreemptFlag())
    with pytest.raises(ValueError, match="CUDA"):
        AK.attn_prefill_mega(words, mine[0].cpu(), *mine[1:], g, 1, flag)
    cut = tuple(t[:, :8].contiguous() for t in mine[:5])
    with pytest.raises(ValueError, match="max_ctx"):
        AK.attn_prefill_mega(words, *cut, mine[5], g, 1, flag)
    mine, _, _ = _attn_inputs("decode", cuda_device, p, seed=0, S=129)
    with pytest.raises(ValueError, match="at most 128"):
        AK.attn_decode_mega(words, *mine, g, 1, flag)
    mine, _, _ = _attn_inputs("decode", cuda_device, p, seed=0)
    with pytest.raises(ValueError, match="table"):
        AK.attn_decode_mega(words, *mine[:3], mine[3][:, :4], mine[4], g, 1,
                            flag)


@pytest.mark.parametrize("cmd", ["scheduler", "cluster"])
def test_cuda_serve_blur_subcommands_megakernel(cuda_device, cmd):
    """``serve scheduler`` / ``serve cluster`` on cuda:0 in megakernel mode:
    every task done through M1, B1 never launched."""
    K.LAUNCHES.reset()
    K.MEGA_LAUNCHES.reset()
    argv = [cmd, "--n-tasks", "4", "--engine", "megakernel", "--quiet"]
    rep = S.main(argv)
    assert rep["n_done"] == 4
    assert K.MEGA_LAUNCHES.total() >= 4 and K.LAUNCHES.total() == 0


# -- the training half on the card --------------------------------------------

def test_cuda_recurrence_wrappers_raise_under_autograd(cuda_device):
    """B4/B5 record no gradient: asked to launch while autograd records and
    an input requires one, their wrappers raise rather than detach; under
    ``no_grad`` (serving) they launch."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.rand((2, 8, 16), device=cuda_device, generator=g)
    b = torch.rand((2, 8, 16), device=cuda_device, generator=g)
    r, k, v = (torch.rand((1, 8, 2, 16), device=cuda_device, generator=g)
               for _ in range(3))
    logw = -torch.rand((1, 8, 2, 16), device=cuda_device, generator=g)
    u = torch.rand((2, 16), device=cuda_device, generator=g)
    with pytest.raises(RuntimeError, match="records no gradient"):
        gops.rglru_scan(a, b.requires_grad_())
    with pytest.raises(RuntimeError, match="records no gradient"):
        wops.rwkv6(r, k, v, logw, u.requires_grad_())
    with torch.no_grad():
        before = GK.LAUNCHES["rglru"]
        gops.rglru_scan(a, b)
        assert GK.LAUNCHES["rglru"] == before + 1
        wops.rwkv6(r, k, v, logw, u)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "mixtral-8x22b"])
def test_cuda_loss_and_gradients_match_the_cpu(cuda_device, arch):
    """The training route (chunked recurrences, plain attention, MoE) on
    the card against the same weights on the CPU: the loss within 1e-5,
    every gradient leaf within 1e-4, every time-mix/RG-LRU projection's
    gradient nonzero.  B4/B5 are not launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as TF

    import torch.utils._pytree as pytree

    cfg = get_config(arch).reduced()
    params = TF.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    loss_fn = LM.make_loss_fn(cfg, remat="full", q_chunk=16)
    out = {}
    for dev in ("cpu", cuda_device):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.to(dev).requires_grad_() for p in flat]
        before = (GK.LAUNCHES.total(), WK.LAUNCHES.total())
        total, _ = loss_fn(pytree.tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        assert (GK.LAUNCHES.total(), WK.LAUNCHES.total()) == before
        out[str(dev)] = (float(total.detach()), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(cuda_device)]
    assert abs(l_cpu - l_dev) <= 1e-5
    for a, b in zip(g_dev, g_cpu):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    names = [pytree.keystr(path) for path, _ in
             pytree.tree_flatten_with_path(params)[0]]
    for name, g in zip(names, g_dev):
        if any(w in name for w in ("'wr'", "'wk'", "'wx'", "'w_lora_a'")):
            assert bool((g != 0).any()), name


def test_cuda_train_loop_restart_equivalence(cuda_device, tmp_path):
    """5 straight steps against a run that crashes after step 3's
    checkpoint and restarts, on cuda:0 (reduced h2o-danube, batch 2, seq
    32): every state leaf within 1e-5 (the reference test's tolerance)."""
    from repro_torch.ckpt.store import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop

    cfg = get_config("h2o-danube-3-4b").reduced()
    kw = dict(steps=5, batch=2, seq=32, quiet=True)

    def crash(step, metrics):
        if step == 2:
            raise KeyboardInterrupt

    full, losses = train_loop(cfg, ckpt_base=str(tmp_path / "a" / "ck"),
                              ckpt_every=100, **kw)
    with pytest.raises(KeyboardInterrupt):
        train_loop(cfg, ckpt_base=str(tmp_path / "b" / "ck"), ckpt_every=3,
                   on_step=crash, **kw)
    resumed, tail = train_loop(cfg, ckpt_base=str(tmp_path / "b" / "ck"),
                               ckpt_every=100, **kw)
    assert np.isfinite(losses).all() and len(tail) == 2
    for a, b in zip(_flatten(full)[0], _flatten(resumed)[0]):
        assert a.is_cuda
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("run", ["ep_decode", "tp", "ep"])
def test_cuda_dbrx_moe_layer_over_the_production_mesh(cuda_device, run,
                                                      monkeypatch):
    """DBRX-132B's MoE layer at full width in f32 (E=16, top-4, D=6144,
    F=10752) on the production 16x16 mesh, single-process binding (256
    shards on cuda:0), TF32 off: ``moe_ffn`` under ``MOE_MODE="ep_decode"``
    on 128 one-token rows, ``moe_ffn`` (TP) and ``moe_ep_ffn`` on 16 x 512
    tokens, against ``moe_ffn_local`` per data shard within 1e-4 x max
    |y|."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as M

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("dbrx-132b")
    mesh = make_production_mesh()
    gen = torch.Generator(cuda_device).manual_seed(0)
    p = M.init_moe_params(cfg.d_model, cfg.d_ff, cfg.moe, generator=gen,
                          device=cuda_device)
    try:
        with torch.no_grad():
            if run == "ep_decode":
                monkeypatch.setattr(M, "MOE_MODE", "ep_decode")
                x = torch.randn(128, 1, cfg.d_model, generator=gen,
                                device=cuda_device)
                want = M.moe_ffn_local(x, p, cfg.moe)[0]
                got = M.moe_ffn(x, p, cfg.moe, mesh)[0]
            else:
                x = torch.randn(16, 512, cfg.d_model, generator=gen,
                                device=cuda_device)
                want = torch.cat([M.moe_ffn_local(xb, p, cfg.moe)[0]
                                  for xb in x.chunk(16)])
                fn = M.moe_ffn if run == "tp" else M.moe_ep_ffn
                got = fn(x, p, cfg.moe, mesh)[0]
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err
    finally:
        del p
        torch.cuda.empty_cache()
