"""The port's system behaviour against the reference's, scenario by
scenario: ``tests/test_system.py`` (the paper's use case, the deprecated
``Controller``), the region-failure and straggler scenarios of
``tests/test_fault_tolerance.py`` and the chunk-pipelined region engine of
``tests/test_chunk_pipeline.py``, its cross-shell migration through the
port's ``ClusterFrontend`` included.

The same numpy inputs, made from a seed, go through both packages in this
process.  Results are compared bitwise (median; gaussian within the
reference's 1e-6, ``tests/test_kernels.py``), and the context a preemption
commits is compared field for field with the reference's after the same
number of chunks.  Preemptions and failures are placed at chunk boundaries
without sleeps: the port's regions call ``on_chunk``; the reference's have
no such hook, so the test wraps their per-iteration failure check, which
the worker calls at the top of its chunk loop, right after each retired
chunk.  Scenarios that are about wall-clock behaviour (service time,
stragglers, full reconfiguration) keep the reference's injected
slowdowns; their results are held against the reference's oracle.  So
are the coalescing scenarios: the reference's scheduler can queue a second
task on a region its serve pass has just refilled, and run it on the
wrong bitstream (``test_a_late_event_never_refills_a_region``), which the
port repairs.

Covered elsewhere, not repeated: a cross-region resume from the
materialized commit (``test_torch_client.py::
test_region_level_cross_region_resume`` and
``test_cross_region_resume_is_bit_identical``).
"""
import functools
import threading
import time
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.controller import abi as R_abi  # noqa: E402
from repro.controller import controller as R_controller  # noqa: E402
from repro.controller import kernels as R_kernels  # noqa: E402
from repro.controller.hittile import HitTile as R_HitTile  # noqa: E402
from repro.core import context as RC  # noqa: E402
from repro.core import interrupts as R_interrupts  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro_torch.controller import Controller  # noqa: E402
from repro_torch.controller import abi as P_abi  # noqa: E402
from repro_torch.controller import kernels as P_kernels  # noqa: E402
from repro_torch.controller.hittile import HitTile as P_HitTile  # noqa: E402
from repro_torch.core import interrupts as P_interrupts  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

SIZE = 128  # pads to [130, 130]: 4 row blocks a pass
TIMEOUT = 60.0
GAUSS_TOL = 1e-6
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")
KINDS = {"MedianBlur": "median", "GaussianBlur": "gaussian"}


def _ref_on_chunk(region, hook):
    """Call ``hook(region, task)`` on the reference region's worker after
    each retired chunk: the worker checks for failure at the top of every
    chunk-loop iteration, so a wrapper around that check sees each chunk
    boundary before the preempt flag is read."""
    check = region._check_failure
    seen = [region.stats.chunks]

    def wrapped():
        check()
        task = region.current_task
        if task is not None and region.stats.chunks > seen[0]:
            seen[0] = region.stats.chunks
            hook(region, task)

    region._check_failure = wrapped


def _port_on_chunk(region, hook):
    region.on_chunk = hook


REF = SimpleNamespace(
    name="ref", Shell=R_shell.Shell, Scheduler=R_scheduler.Scheduler,
    SchedulerConfig=R_scheduler.SchedulerConfig, Task=R_task.Task,
    TaskStatus=R_task.TaskStatus, EventKind=R_interrupts.EventKind,
    get_kernel=R_kernels.get_kernel, Controller=R_controller.Controller,
    HitTile=R_HitTile, generate=R_task.generate_random_tasks, default=None,
    on_chunk=_ref_on_chunk,
    shell_kw=lambda engine: {"pipeline": engine == "pipelined"})
PORT = SimpleNamespace(
    name="port", Shell=P_shell.Shell, Scheduler=P_scheduler.Scheduler,
    SchedulerConfig=P_scheduler.SchedulerConfig, Task=P_task.Task,
    TaskStatus=P_task.TaskStatus, EventKind=P_interrupts.EventKind,
    get_kernel=P_kernels.get_kernel, Controller=Controller,
    HitTile=P_HitTile, generate=P_task.generate_random_tasks,
    default=["cpu"], on_chunk=_port_on_chunk,
    shell_kw=lambda engine: {"engine": engine})
SIDES = (REF, PORT)


def _shell(side, n_regions=1, engine="pipelined", **kw):
    return side.Shell(n_regions=n_regions, devices=side.default,
                      **side.shell_kw(engine), **kw)


def _task(side, img, iters=2, kernel="MedianBlur", priority=2, **kw):
    kd = side.get_kernel(kernel)
    return side.Task(kernel=kernel,
                     args=kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                    W=SIZE, iters=iters),
                     priority=priority, **kw)


def _oracle(img, iters, kernel):
    return np.asarray(iterated_blur_ref(jnp.asarray(img), iters,
                                        KINDS[kernel]))


def _check(kernel, got, want):
    if kernel == "MedianBlur":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_TOL)


def _result(task):
    return tuple(np.asarray(b) for b in task.result)


def _same_results(kernel, ref, port):
    for a, b in zip(ref, port):
        _check(kernel, np.asarray(b), np.asarray(a))


def _wait_for(cond, timeout=TIMEOUT, dt=0.005):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return cond()


_jit = functools.lru_cache(maxsize=None)(jax.jit)


def _ref_contexts(img, iters, budget, kernel="MedianBlur"):
    """The reference's context fields after every chunk of an
    uninterrupted run (its jitted chunk; the Pallas blur in interpret
    mode)."""
    kd = R_kernels.get_kernel(kernel)
    bufs, ints, floats = kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                   W=SIZE, iters=iters).padded()
    chunk = _jit(kd.fn)
    ctx = RC.ContextRecord.fresh()
    state = tuple(jnp.asarray(b) for b in bufs)
    out = []
    while int(ctx.done) == 0:
        ctx, state = chunk(ctx.with_budget(budget), state, ints, floats)
        out.append({f: np.asarray(getattr(ctx, f)) for f in FIELDS})
        assert len(out) < 2000
    return out


def _drive(side, shell, task, preempt_at=None, resume=None):
    """Drive one task on a shell's regions directly (no scheduler): launch
    on region 0; with ``preempt_at``, request one preemption at the chunk
    boundary after that many of the task's chunks, and resume on
    ``resume`` (default: the same region).  Returns the commits the
    preemptions made."""
    regions = shell.regions
    target = regions[0]
    if preempt_at is not None:
        seen = [0]

        def hook(region, t):
            seen[0] += 1
            if seen[0] == preempt_at:
                region.request_preempt()

        for r in regions:
            side.on_chunk(r, hook)
    target.enqueue_reconfig(task)
    target.enqueue_launch(task)
    commits = []
    while True:
        ev = shell.interrupts.wait(TIMEOUT)
        assert ev is not None, f"stuck: {task}"
        if ev.kind is side.EventKind.TASK_DONE:
            break
        if ev.kind is side.EventKind.TASK_PREEMPTED:
            commits.append(task.saved_context)
            target = resume if resume is not None else target
            target.enqueue_reconfig(task)
            target.enqueue_launch(task)
    for r in regions:  # a preempt that raced completion must not leak
        r.cancel_preempt()
    return commits


def _uninterrupted(side, img, iters, budget, kernel="MedianBlur",
                   engine="sync"):
    shell = _shell(side, chunk_budget=budget, engine=engine, prefetch=False)
    try:
        t = _task(side, img, iters=iters, kernel=kernel)
        _drive(side, shell, t)
        return _result(t), shell.regions[0].stats
    finally:
        shell.shutdown()


# ------------------------------------------------------------------ system
def test_kernel_registry_has_paper_task_set():
    names = P_kernels.kernel_names()
    assert "MedianBlur" in names and "GaussianBlur" in names
    for name in ("MedianBlur", "GaussianBlur"):
        kd, rkd = P_kernels.get_kernel(name), R_kernels.get_kernel(name)
        assert kd.int_args == rkd.int_args == ("H", "W", "iters")
    # the uniform ABI pads to fixed widths (paper Listing 1.2)
    args = (np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32))
    bufs, ints, floats = P_kernels.get_kernel("MedianBlur").bundle(
        *args, H=2, W=2, iters=1).padded()
    rbufs, rints, rfloats = R_kernels.get_kernel("MedianBlur").bundle(
        *args, H=2, W=2, iters=1).padded()
    assert len(bufs) == len(rbufs) == P_abi.N_BUF_SLOTS == R_abi.N_BUF_SLOTS
    np.testing.assert_array_equal(ints, np.asarray(rints))
    np.testing.assert_array_equal(floats, np.asarray(rfloats))
    assert ints.shape == (8,) and floats.shape == (8,)


def _controller(side, img):
    shell = _shell(side, n_regions=2, chunk_budget=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctrl = side.Controller(shell)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    try:
        t1 = ctrl.launch("MedianBlur", (side.HitTile.of(img),
                                        side.HitTile.zeros(img.shape)),
                         priority=1, H=SIZE, W=SIZE, iters=2)
        t2 = ctrl.launch("GaussianBlur", (side.HitTile.of(img),
                                          side.HitTile.zeros(img.shape)),
                         priority=3, H=SIZE, W=SIZE, iters=1)
        rep = ctrl.run(quiet=True)
        assert ctrl.wait(t1, timeout=TIMEOUT) is t1
        assert t1.status is side.TaskStatus.DONE
        assert t2.status is side.TaskStatus.DONE
        return rep["n_done"], _result(t1), _result(t2)
    finally:
        ctrl.shutdown()


def test_controller_end_to_end():
    img = make_image(np.random.default_rng(0), SIZE)
    ref, port = (_controller(s, img) for s in SIDES)
    assert port[0] == ref[0] == 2
    _same_results("MedianBlur", ref[1], port[1])
    _same_results("GaussianBlur", ref[2], port[2])
    _check("MedianBlur", port[1][0], _oracle(img, 2, "MedianBlur"))
    _check("GaussianBlur", port[2][1], _oracle(img, 1, "GaussianBlur"))


def _soup(side, preemption, seed=15, n_tasks=12, n_regions=2, rate=0.3,
          slowdown=0.05):
    """The reference's ``_run_soup``: a seeded random stream of blur tasks
    of 2-4 iterations on two regions, both bitstreams prewarmed."""
    rng = np.random.default_rng(seed)

    def arg_factory(r, k):
        img = make_image(r, SIZE)
        return side.get_kernel(k).bundle(img, np.zeros_like(img), H=SIZE,
                                         W=SIZE,
                                         iters=int(r.integers(2, 5)))

    tasks = side.generate(rng, ["MedianBlur", "GaussianBlur"], n_tasks,
                          rate, arg_factory)
    shell = side.Shell(n_regions=n_regions, chunk_budget=1,
                       devices=side.default)
    try:
        for kname in ("MedianBlur", "GaussianBlur"):
            shell.engine.prewarm(kname, tasks[0].args, (1,))
        for r in shell.regions:
            r.slowdown_s = slowdown
        sched = side.Scheduler(shell, side.SchedulerConfig(
            preemption=preemption))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    return rep, tasks


def _check_soup_against_oracle(tasks):
    for t in tasks:
        iters = int(t.args.ints[2])
        img = np.asarray(t.args.bufs[0])
        _check(t.kernel, t.result[iters % 2], _oracle(img, iters, t.kernel))


def test_preemption_reduces_urgent_service_time():
    """Paper Fig. 3 (qualitative): with preemption, high-priority tasks
    are served sooner on average than without; every result equals the
    reference's oracle."""
    rep_np, tasks_np = _soup(PORT, False)
    rep_p, tasks_p = _soup(PORT, True)
    assert rep_np["n_done"] == rep_p["n_done"] == 12
    assert rep_np["preemptions"] == 0
    assert rep_p["preemptions"] > 0, "scenario generated no preemptions"

    def urgent_mean(tasks):
        st = [t.service_time for t in tasks if t.priority <= 1]
        return np.mean(st) if st else 0.0

    assert urgent_mean(tasks_p) <= urgent_mean(tasks_np) * 1.5
    _check_soup_against_oracle(tasks_np)
    _check_soup_against_oracle(tasks_p)


def test_reconfiguration_cache_hits():
    """Repeated kernels on the same region geometry hit the bitstream
    cache in both packages on the same seeded stream; the port's images
    equal the reference's oracle."""
    (ref, ref_tasks), (port, port_tasks) = (
        _soup(s, True, seed=3, n_tasks=10) for s in SIDES)
    for rep in (ref, port):
        assert rep["n_done"] == 10
        assert rep["cache_hits"] > 0
        assert rep["cold_compiles"] <= 4  # 2 kernels x <=2 signatures
    assert port["cold_compiles"] == ref["cold_compiles"]
    for a, b in zip(ref_tasks, port_tasks):
        assert (b.kernel, b.priority, b.arrival_time) == (
            a.kernel, a.priority, a.arrival_time)
    _check_soup_against_oracle(port_tasks)


def test_full_reconfig_mode_slower_than_partial():
    """Paper §6.3: full reconfiguration stalls the fabric; with simulated
    bitstream load times throughput must drop."""
    def arg_factory(r, k):
        img = make_image(r, SIZE)
        return P_kernels.get_kernel(k).bundle(img, np.zeros_like(img),
                                              H=SIZE, W=SIZE, iters=1)

    def run(full_mode):
        tasks = P_task.generate_random_tasks(
            np.random.default_rng(15), ["MedianBlur", "GaussianBlur"], 8,
            0.05, arg_factory)
        shell = P_shell.Shell(n_regions=2, chunk_budget=8, devices=["cpu"],
                              simulate_partial_s=0.0 if full_mode else 0.01,
                              simulate_full_s=0.03 if full_mode else 0.0)
        try:
            for kname in ("MedianBlur", "GaussianBlur"):
                shell.engine.prewarm(kname, tasks[0].args,
                                     shell.regions[0].geometry)
            sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
                preemption=False, full_reconfig_mode=full_mode))
            rep = sched.run(tasks, quiet=True)
        finally:
            shell.shutdown()
        for t in tasks:
            _check(t.kernel, t.result[1],
                   _oracle(np.asarray(t.args.bufs[0]), 1, t.kernel))
        return rep

    rep_partial = run(False)
    rep_full = run(True)
    assert rep_full["full_reconfigs"] > 0
    assert rep_partial["full_reconfigs"] == 0
    assert rep_partial["throughput_tps"] > rep_full["throughput_tps"]


# --------------------------------------------------------- fault tolerance
def _failover(side, img):
    t = _task(side, img, iters=3)
    shell = _shell(side, n_regions=2, chunk_budget=1)
    killed, seen = [], [0]

    def kill(region, task):
        seen[0] += 1
        if task is t and seen[0] == 3:
            killed.append(region.rid)
            region.inject_failure()

    for r in shell.regions:
        side.on_chunk(r, kill)
    try:
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=True))
        rep = sched.run([t], quiet=True)
    finally:
        shell.shutdown()
    assert t.status is side.TaskStatus.DONE
    return rep["n_done"], killed, t.region_history, _result(t)


def test_region_failure_migrates_task():
    """Kill the region running the task at its third chunk boundary: the
    task finishes on the other region, the same way in both packages,
    with the uninterrupted result.  (The port's loop also waits for the
    failure event of a dispatched task before it may exit; the reference's
    can exit first and strand the task queued, a race this placement
    keeps the reference clear of.)"""
    img = make_image(np.random.default_rng(2), SIZE)
    ref, port = (_failover(s, img) for s in SIDES)
    assert port[:3] == ref[:3]
    assert port[0] == 1 and len(set(port[2])) == 2
    _same_results("MedianBlur", ref[3], port[3])
    want, _ = _uninterrupted(PORT, img, 3, 1)
    _same_results("MedianBlur", want, port[3])


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_all_regions_dead_raises(side):
    t = _task(side, make_image(np.random.default_rng(3), SIZE), iters=3)
    shell = _shell(side, chunk_budget=1)
    try:
        shell.regions[0].inject_failure()
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=True))
        with pytest.raises(RuntimeError, match="all regions failed"):
            sched.run([t], quiet=True)
    finally:
        shell.shutdown()


def test_straggler_migration():
    """A region whose chunks read 50x slower than its peer's must lose its
    task to migration; every result equals the reference's oracle.  The
    straggler is made without the wall clock: from its third chunk on, its
    ``on_chunk`` hook sets its chunk EWMA to 50x the other region's and
    holds the worker at that boundary until the scheduler has asked for
    the preemption (once), so detection never races the task's end."""
    rng = np.random.default_rng(4)
    imgs = [make_image(rng, SIZE) for _ in range(6)]
    tasks = [_task(PORT, im, iters=3) for im in imgs]
    shell = P_shell.Shell(n_regions=2, chunk_budget=1, devices=["cpu"])
    fast, slow = shell.regions
    asked = threading.Event()

    def straggle(region, task):
        if region.stats.chunks < 3 or asked.is_set():
            return
        # the scheduler reads the EWMAs of both regions once each has
        # retired 3 chunks: wait for the peer's history too
        _wait_for(lambda: fast.stats.chunks >= 3 and
                  fast.stats.chunk_ewma_s > 0)
        region.stats.chunk_ewma_s = 50 * fast.stats.chunk_ewma_s
        if _wait_for(region._preempt.is_set):
            asked.set()

    slow.on_chunk = straggle
    try:
        shell.engine.prewarm("MedianBlur", tasks[0].args, (1,))
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
            preemption=True, straggler_factor=5.0))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    assert asked.is_set(), "the scheduler never asked the straggler"
    assert rep["n_done"] == 6
    assert rep["migrations"] >= 1, "straggler was never migrated"
    for t, im in zip(tasks, imgs):
        _check("MedianBlur", t.result[1], _oracle(im, 3, "MedianBlur"))


# --------------------------------------------------- chunk-pipelined engine
def test_pipelined_matches_sync_bit_identical():
    img = make_image(np.random.default_rng(7), SIZE)
    ref, ref_stats = _uninterrupted(REF, img, 2, 2)
    sync, sync_stats = _uninterrupted(PORT, img, 2, 2)
    pipe, stats = _uninterrupted(PORT, img, 2, 2, engine="pipelined")
    assert sync_stats.chunks == ref_stats.chunks
    _same_results("MedianBlur", sync, pipe)
    _same_results("MedianBlur", ref, pipe)
    # the pipeline overlapped chunks and discarded exactly the one
    # speculative chunk issued past completion
    assert stats.chunks_pipelined > 0 and stats.chunks_discarded == 1
    assert stats.chunks == sync_stats.chunks


@pytest.mark.parametrize("engine", ["sync", "pipelined"])
def test_preempt_at_every_chunk_boundary_bit_identical(engine):
    """A preemption at each chunk boundary k (resumed on the same region
    from device memory) never changes the output, and the context it
    commits equals the reference's after the same chunks: k in the sync
    engine, k + 1 in the pipelined one (its speculative chunk retires
    before the commit)."""
    img = make_image(np.random.default_rng(8), SIZE)
    iters, budget = 2, 2
    want = _ref_contexts(img, iters, budget)
    ref, _ = _uninterrupted(REF, img, iters, budget)
    ahead = 1 if engine == "pipelined" else 0
    n_chunks = len(want)
    assert n_chunks >= 3
    for k in range(1, n_chunks):
        shell = _shell(PORT, chunk_budget=budget, engine=engine,
                       prefetch=False)
        try:
            t = _task(PORT, img, iters=iters)
            commits = _drive(PORT, shell, t, preempt_at=k)
            assert t.status is P_task.TaskStatus.DONE
            _same_results("MedianBlur", ref, _result(t))
            if k + ahead >= n_chunks:  # the task finished first
                assert commits == []
                continue
            assert len(commits) == 1 and t.n_preemptions == 1
            got = commits[0].context.fields()
            for f in FIELDS:
                np.testing.assert_array_equal(
                    got[f], want[k + ahead - 1][f],
                    err_msg=f"{f} at boundary {k}")
        finally:
            shell.shutdown()


@pytest.mark.parametrize("budget,iters,kernel,preempt_at,seed", [
    (1, 2, "MedianBlur", 3, 0),
    (2, 1, "GaussianBlur", 1, 1),
    (3, 3, "MedianBlur", 1, 2),
    (4, 2, "GaussianBlur", 2, 3),
    (1, 3, "GaussianBlur", 7, 4),
    (2, 3, "MedianBlur", 5, 5),
])
def test_property_pipelined_preemption_equivalence(budget, iters, kernel,
                                                   preempt_at, seed):
    """The reference's property, on a fixed grid: pipelined execution with
    a preemption at a given boundary is bit-identical to the synchronous
    uninterrupted run of the port, and equals the reference's."""
    img = make_image(np.random.default_rng(seed), SIZE)
    ref, _ = _uninterrupted(REF, img, iters, budget, kernel)
    sync, _ = _uninterrupted(PORT, img, iters, budget, kernel)
    shell = _shell(PORT, chunk_budget=budget, prefetch=False)
    try:
        t = _task(PORT, img, iters=iters, kernel=kernel)
        _drive(PORT, shell, t, preempt_at=preempt_at)
        for a, b in zip(sync, _result(t)):
            np.testing.assert_array_equal(b, a)
        _same_results(kernel, ref, _result(t))
    finally:
        shell.shutdown()


def test_same_region_resume_is_device_resident():
    """A preempt+resume cycle on one region avoids the host round trip:
    the commit stays device-resident and the resume consumes it in place;
    its host copy is produced on demand and cached."""
    img = make_image(np.random.default_rng(9), SIZE)
    ref, _ = _uninterrupted(REF, img, 3, 1)
    shell = _shell(PORT, chunk_budget=1, prefetch=False)
    region = shell.regions[0]
    try:
        t = _task(PORT, img, iters=3)
        commits = _drive(PORT, shell, t, preempt_at=2)
        assert len(commits) == 1
        assert region.stats.host_spills_avoided == 1
        committed = region.bank.restore()
        assert committed is commits[0] and committed.device
        assert committed.owner is region and committed.tid == t.tid
        _same_results("MedianBlur", ref, _result(t))
        host = committed.materialize()
        assert not host.device and host.tid == t.tid
        assert committed.materialize() is host
    finally:
        shell.shutdown()


def test_cross_shell_migration_consumes_lazy_spill(tmp_path):
    """Checkpoint-migrating a *running* task to another shell consumes the
    device-resident commit through the checksummed disk spill and resumes
    bit-identically to an uninterrupted single-shell run.  The migration
    lands at the task's second chunk boundary: the region's ``on_chunk``
    holds the worker there until the driving thread's ``migrate`` has
    asked for the preemption."""
    import os

    from repro_torch.ckpt.store import load_pytree
    from repro_torch.cluster import ClusterFrontend

    img = make_image(np.random.default_rng(11), SIZE)
    ref, _ = _uninterrupted(REF, img, 3, 1)
    want, _ = _uninterrupted(PORT, img, 3, 1)
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1, chunk_budget=1,
                         rebalance=False, devices=PORT.default,
                         spill_dir=str(tmp_path))
    t = _task(PORT, img, iters=3)
    reached = threading.Event()

    def hold(region, task):
        if task is t and not reached.is_set() and region.stats.chunks == 2:
            reached.set()
            _wait_for(region._preempt.is_set)

    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = hold
    try:
        h = fe.submit(t)
        assert reached.wait(TIMEOUT)
        assert fe.migrate(tid=t.tid), "forced migration never completed"
        # the lazy commit was spilled through the on-disk checkpoint
        src = fe.nodes[0].shell.regions[0].bank.restore()
        assert src.device and src.tid == t.tid
        spills = [f for f in os.listdir(fe.spill_dir)
                  if f.startswith(f"task{t.tid}.") and f.endswith(".npz")]
        assert spills == [f"task{t.tid}.hop0.migration.npz"]
        host = src.materialize()
        loaded = load_pytree(os.path.join(fe.spill_dir, spills[0]),
                             {"context": host.context,
                              "payload": host.payload})  # CRC-verified
        for a, b in zip(loaded["payload"], host.payload):
            np.testing.assert_array_equal(a, b)
        out = tuple(np.asarray(b) for b in h.result(timeout=TIMEOUT))
        assert h.n_migrations == 1
        _same_results("MedianBlur", want, out)
        _same_results("MedianBlur", ref, out)
    finally:
        rep = fe.shutdown()
    assert rep["stranded_handles"] == 0 and rep["lost_tasks"] == 0


def _coalescing(side, imgs, coalesce):
    shell = _shell(side, chunk_budget=2, prefetch=False)
    try:
        tasks = [_task(side, im, iters=1, kernel=k) for im, k in
                 zip(imgs, ("MedianBlur", "GaussianBlur", "MedianBlur"))]
        for k in ("MedianBlur", "GaussianBlur"):
            shell.engine.prewarm(k, tasks[0].args, (1,))
        sched = side.Scheduler(shell, side.SchedulerConfig(
            coalescing=coalesce))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == 3 and rep["stranded_handles"] == 0
    order = [t.kernel for t in sorted(tasks, key=lambda t: t.t_first_served)]
    return (rep["reconfigs"], rep["coalesced_dispatches"], order,
            [_result(t) for t in tasks])


def _check_against_oracle(imgs, kernels, results, iters=1):
    for im, k, res in zip(imgs, kernels, results):
        _check(k, res[iters % 2], _oracle(im, iters, k))


MGM = ("MedianBlur", "GaussianBlur", "MedianBlur")


@pytest.mark.parametrize("coalesce", [True, False])
def test_coalescing_reduces_reconfigs_and_strands_nothing(coalesce):
    """[M, G, M] on one region: with coalescing the finished region picks
    up the queued same-bitstream task back to back (2 reconfigs instead
    of 3).  Held to the reference's outcome and oracle, not to a run of
    it: the reference can queue a second task on a region its serve pass
    has just refilled (``test_a_late_event_never_refills_a_region``)."""
    rng = np.random.default_rng(12)
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    reconfigs, coalesced, order, results = _coalescing(PORT, imgs, coalesce)
    if coalesce:
        assert (reconfigs, coalesced) == (2, 1)
        assert order == ["MedianBlur", "MedianBlur", "GaussianBlur"]
    else:
        assert (reconfigs, coalesced) == (3, 0)
        assert order == list(MGM)
    _check_against_oracle(imgs, MGM, results)


def test_a_late_event_never_refills_a_region():
    """The race behind a fault of the reference's scheduler, forced step
    by step: m1 finishes and its region goes idle before the loop handles
    m1's TASK_DONE, with g (Gaussian) and m2 (MedianBlur) queued.  The
    reference's serve pass refills the idle region with g (a queued reload
    of the Gaussian bitstream), then takes m1's late event as proof the
    region is free and coalesces m2 onto it, which runs on the Gaussian
    bitstream.  The port dispatches nothing to a region whose last task
    has not settled: the late event frees it, m2 coalesces onto the warm
    MedianBlur bitstream, and g follows with its own."""
    rng = np.random.default_rng(21)
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    shell = _shell(PORT, chunk_budget=2, prefetch=False)
    try:
        m1, g, m2 = (_task(PORT, im, iters=1, kernel=k)
                     for im, k in zip(imgs, MGM))
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig())
        sched.t0 = time.perf_counter()
        region = shell.regions[0]
        sched._dispatch(region, m1)
        ev = shell.interrupts.wait(TIMEOUT)
        while (ev is not None
               and ev.kind is not P_interrupts.EventKind.TASK_DONE):
            ev = shell.interrupts.wait(TIMEOUT)
        assert ev is not None and ev.task is m1
        assert _wait_for(lambda: region.idle)
        for t in (g, m2):
            t.status = P_task.TaskStatus.QUEUED
            sched.policy.enqueue(t)
        sched._serve()            # the region is idle but unsettled
        assert len(sched.policy.pending_tasks()) == 2
        sched._handle(ev)         # m1's late TASK_DONE settles it
        assert sched.coalesced_dispatches == 1
        done = []
        while len(done) < 2:
            e = shell.interrupts.wait(TIMEOUT)
            assert e is not None, "stuck"
            sched._handle(e)
            if e.kind is P_interrupts.EventKind.TASK_DONE:
                done.append(e.task)
            assert _wait_for(lambda: region.idle)
            sched._serve()
    finally:
        shell.shutdown()
    assert done == [m2, g]
    assert m2.n_reconfigs == 0 and g.n_reconfigs == 1
    _check_against_oracle(imgs, MGM, [m1.result, g.result, m2.result])


def _no_cross_level(side, imgs):
    """m1 runs; at its first chunk boundary an urgent Gaussian g0 and a
    same-bitstream m2 (m1's level) arrive and queue behind it."""
    shell = _shell(side, chunk_budget=1)
    m1 = _task(side, imgs[0], iters=2, priority=3)
    g0 = _task(side, imgs[1], iters=1, kernel="GaussianBlur", priority=0)
    m2 = _task(side, imgs[2], iters=1, priority=3)
    for k in ("MedianBlur", "GaussianBlur"):
        shell.engine.prewarm(k, m1.args, (1,))
    sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
    server = threading.Thread(target=sched.run_forever, daemon=True)
    server.start()
    handles = []

    def arrive(region, task):
        if task is m1 and not handles:
            handles.extend(sched.submit(t) for t in (g0, m2))
            assert _wait_for(lambda: len(sched.policy.pending_tasks()) == 2)

    side.on_chunk(shell.regions[0], arrive)
    try:
        assert sched.wait_until_serving(timeout=10.0)
        sched.submit(m1).result(timeout=TIMEOUT)
        for h in handles:
            h.result(timeout=TIMEOUT)
        rep = sched.drain(timeout=TIMEOUT)
    finally:
        sched.shutdown(timeout=10.0)
        server.join(timeout=10.0)
        shell.shutdown()
    assert rep["n_done"] == 3
    order = [t for t in sorted((m1, g0, m2),
                               key=lambda t: t.t_first_served)]
    return ([(t.kernel, t.priority) for t in order],
            rep["coalesced_dispatches"], [_result(t) for t in (m1, g0, m2)])


def test_coalescing_never_crosses_priority_levels():
    """A same-bitstream task at a lower priority must not jump a
    higher-priority head of another kernel when the region frees (held
    to the reference's outcome and oracle, as above)."""
    rng = np.random.default_rng(13)
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    order, coalesced, results = _no_cross_level(PORT, imgs)
    assert order == [("MedianBlur", 3), ("GaussianBlur", 0),
                     ("MedianBlur", 3)]
    assert coalesced == 0
    _check_against_oracle(imgs[:1], MGM[:1], results[:1], iters=2)
    _check_against_oracle(imgs[1:], MGM[1:], results[1:])


# ----------------------------------------------------- repair drain race
def _dead_worker(region):
    assert _wait_for(lambda: not region._thread.is_alive(), timeout=10.0)


def test_repair_returns_dropped_launch_commands():
    """Commands still queued when a dead worker is repaired are handed
    back for requeue instead of being silently dropped."""
    rng = np.random.default_rng(17)
    shell = _shell(PORT, chunk_budget=2, prefetch=False)
    region = shell.regions[0]
    try:
        t1 = _task(PORT, make_image(rng, SIZE), iters=1)
        t2 = _task(PORT, make_image(rng, SIZE), iters=1)
        region.inject_failure()
        region.enqueue_launch(t1)  # the worker hits the failure and dies
        _dead_worker(region)
        region.enqueue_launch(t2)  # lands on a dead region's queue
        assert not region.idle
        assert region.repair() == [t2]
        assert region.alive and region.idle
        ev = shell.interrupts.drain()
        assert any(e.kind is P_interrupts.EventKind.REGION_FAILED
                   for e in ev)
    finally:
        shell.shutdown()


def test_repair_drain_is_atomic_and_reconciles_inflight():
    """Every command queued on the dead region is either handed back by
    repair() or preserved with a consistent inflight count; enqueues
    after the repair run normally."""
    rng = np.random.default_rng(18)
    shell = _shell(PORT, chunk_budget=2, prefetch=False)
    region = shell.regions[0]
    try:
        t0 = _task(PORT, make_image(rng, SIZE), iters=1)
        region.inject_failure()
        region.enqueue_launch(t0)  # the worker dies on it
        _dead_worker(region)
        shell.interrupts.drain()
        queued = []
        for _ in range(3):
            t = _task(PORT, make_image(rng, SIZE), iters=1)
            region.enqueue_reconfig(t)
            region.enqueue_launch(t)
            queued.append(t)
        assert not region.idle
        assert region.repair() == queued  # launch commands, in order
        with region._inflight_lock:
            assert region._inflight == region._q.qsize() == 0
        assert region.alive and region.idle
        img = make_image(rng, SIZE)
        t1 = _task(PORT, img, iters=1)
        region.enqueue_reconfig(t1)
        region.enqueue_launch(t1)
        while True:
            ev = shell.interrupts.wait(TIMEOUT)
            assert ev is not None, "the repaired region never finished"
            if ev.kind is P_interrupts.EventKind.TASK_DONE:
                break
        assert t1.status is P_task.TaskStatus.DONE
        _check("MedianBlur", t1.result[1], _oracle(img, 1, "MedianBlur"))
    finally:
        shell.shutdown()


def test_auto_repair_skips_already_requeued_tasks(monkeypatch):
    """A task the REGION_FAILED handler already requeued (or re-dispatched
    to another region) must not be enqueued again by the auto-repair
    requeue."""
    rng = np.random.default_rng(20)
    shell = _shell(PORT, chunk_budget=2, prefetch=False)
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
            repair_after_s=0.0))
        region = shell.regions[0]
        requeued, dropped_only, elsewhere = (
            _task(PORT, make_image(rng, SIZE), iters=1) for _ in range(3))
        for t in (requeued, dropped_only, elsewhere):
            t.status = P_task.TaskStatus.QUEUED
            t.last_dispatched_rid = region.rid
        elsewhere.last_dispatched_rid = region.rid + 1
        sched.policy.enqueue(requeued)
        monkeypatch.setattr(region, "repair",
                            lambda: [requeued, dropped_only, elsewhere])
        sched.t0 = time.perf_counter()
        sched._dead_since[region.rid] = 0.0
        sched._maybe_repair()
        pending = sched.policy.pending_tasks()
        assert sum(1 for t in pending if t is requeued) == 1
        assert sum(1 for t in pending if t is dropped_only) == 1
        assert sum(1 for t in pending if t is elsewhere) == 0
    finally:
        shell.shutdown()


# ------------------------------------------------- event-driven controller
def test_controller_wait_is_event_driven():
    img = make_image(np.random.default_rng(19), SIZE)
    shell = _shell(PORT, chunk_budget=2, prefetch=False)
    with pytest.warns(DeprecationWarning, match="repro_torch.Client"):
        ctrl = Controller(shell)
    try:
        t = ctrl.launch("MedianBlur", (img, np.zeros_like(img)),
                        priority=1, H=SIZE, W=SIZE, iters=1)
        with pytest.raises(TimeoutError):
            ctrl.wait(t, timeout=0.1)  # never run -> no handle registered
        th = threading.Thread(target=ctrl.run, kwargs={"quiet": True})
        th.start()
        # a wait racing run() blocks through handle registration, then on
        # completion
        got = ctrl.wait(t, timeout=TIMEOUT)
        assert got.status is P_task.TaskStatus.DONE
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()
        # raw arrays pass as they are (only HitTiles unwrap)
        _check("MedianBlur", t.result[1], _oracle(img, 1, "MedianBlur"))
    finally:
        ctrl.shutdown()


def test_controller_is_exported_lazily():
    import repro_torch.controller as ctl

    assert ctl.Controller is Controller
    with pytest.raises(AttributeError):
        ctl.NoSuchThing  # noqa: B018
