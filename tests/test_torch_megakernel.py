"""The port's megakernel engine against the reference's, side by side in one
process: the twins of ``tests/test_megakernel.py`` on ``devices=["cpu"]``,
where a launch is the plain version of the persistent kernel (a host loop
over the chunk entry with the reference's stop rule).

- single-dispatch bit identity, engine-mode validation, the flag at every
  chunk boundary (same-region and cross-region resume), the (budget,
  preempt_at) property as the deterministic corners of
  ``test_megakernel.py``'s fallback, the stale budget (the port passes
  the budget by value, so the behaviour is asserted, not a scalar cache),
  the task budget override on the sync engine, the backoff wait (for the
  chunk wait and the megakernel launch wait) and the report counters;
- parity: after a flag exit at each boundary ``k`` the port's committed
  context equals the reference megakernel's field by field, and the images
  equal; ``ops.blur_mega`` (the persistent entry's plain version) against
  the reference's ``make_megakernel`` called directly;
- on the card the engine runs only through a kernel's persistent entry:
  a kernel without one (registered by the test: every built-in task has
  one) raises, and the host loop is never bound there;
- the serving engine's preempt probe arms the one-shot flag in megakernel
  mode, and the streams stay equal to the oracle.

``test_megakernel.py::test_flag_exit_cross_shell_migration``'s twin
migrates a running launch between the two CPU shells of a
``ClusterFrontend`` at a boundary placed with ``on_chunk``.  Tolerances: median images and every
context field bitwise; gaussian images within 1e-6 (the reference's,
``tests/test_kernels.py``: its Pallas blur runs in interpret mode, the
port's plain version sums the same terms in the same order).
"""
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.controller import kernels as R_kernels  # noqa: E402
from repro.core import interrupts as R_interrupts  # noqa: E402
from repro.core import preemption as R_pre  # noqa: E402
from repro.core import reconfig as R_reconfig  # noqa: E402
from repro.core import region as R_region  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro.core.context import ContextRecord as R_Ctx  # noqa: E402
from repro.kernels.blur.tasks import make_image  # noqa: E402
from repro_torch.controller import kernels as P_kernels  # noqa: E402
from repro_torch.core import interrupts as P_interrupts  # noqa: E402
from repro_torch.core import preemption as P_pre  # noqa: E402
from repro_torch.core import region as P_region  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402
from repro_torch.core.context import (CTX_WORDS,  # noqa: E402
                                      ContextRecord as P_Ctx)
from repro_torch.core.reconfig import ReconfigEngine  # noqa: E402
from repro_torch.core.reporting import SCHEMA  # noqa: E402
from repro_torch.kernels.blur import ops as P_ops  # noqa: E402

SIZE = 30          # pads to [130, 130]: 4 row blocks a pass
TIMEOUT = 60.0
GAUSS_TOL = 1e-6
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")

REF = SimpleNamespace(
    name="ref", Shell=R_shell.Shell, Scheduler=R_scheduler.Scheduler,
    SchedulerConfig=R_scheduler.SchedulerConfig, Task=R_task.Task,
    TaskStatus=R_task.TaskStatus, EventKind=R_interrupts.EventKind,
    get_kernel=R_kernels.get_kernel, devices=None)
PORT = SimpleNamespace(
    name="port", Shell=P_shell.Shell, Scheduler=P_scheduler.Scheduler,
    SchedulerConfig=P_scheduler.SchedulerConfig, Task=P_task.Task,
    TaskStatus=P_task.TaskStatus, EventKind=P_interrupts.EventKind,
    get_kernel=P_kernels.get_kernel, devices=["cpu"])
SIDES = (REF, PORT)


def _shell(side, n_regions=1, engine="megakernel", chunk_budget=2, **kw):
    return side.Shell(n_regions=n_regions, chunk_budget=chunk_budget,
                      engine=engine, prefetch=False, devices=side.devices,
                      **kw)


def _task(side, img, iters=2, kernel="MedianBlur"):
    kd = side.get_kernel(kernel)
    return side.Task(kernel=kernel,
                     args=kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                    W=SIZE, iters=iters))


def _drive(side, shell, task, arm=None, rearm=False, resume_region=None):
    """As the reference test's `_drive`: one task on region 0; ``arm`` writes
    the one-shot ``preempt_at_boundary`` before the launch (each launch,
    if ``rearm``).  Returns the commits the flag exits made, in order."""
    target = shell.regions[0]
    target.enqueue_reconfig(task)
    if arm is not None:
        task.preempt_at_boundary = arm
    target.enqueue_launch(task)
    commits = []
    deadline = time.perf_counter() + TIMEOUT
    while True:
        assert time.perf_counter() < deadline, f"stuck: {task}"
        ev = shell.interrupts.wait(0.0005)
        if ev is None:
            continue
        assert ev.kind is not side.EventKind.REGION_FAILED, ev
        if ev.kind is side.EventKind.TASK_DONE:
            break
        if ev.kind is side.EventKind.TASK_PREEMPTED:
            commits.append(task.saved_context)
            target.cancel_preempt()
            target = resume_region if resume_region is not None else target
            target.enqueue_reconfig(task)
            if rearm and arm is not None:
                task.preempt_at_boundary = arm
            target.enqueue_launch(task)
    for r in shell.regions:
        r.cancel_preempt()
    return commits


def _run(side, img, iters=2, kernel="MedianBlur", engine="megakernel",
         budget=2, **drive_kw):
    """One task through a fresh one-region shell (two with a cross-region
    resume); returns (result, commits, region stats)."""
    n = 2 if drive_kw.pop("cross_region", False) else 1
    shell = _shell(side, n_regions=n, engine=engine, chunk_budget=budget)
    try:
        t = _task(side, img, iters=iters, kernel=kernel)
        if n == 2:
            drive_kw["resume_region"] = shell.regions[1]
        commits = _drive(side, shell, t, **drive_kw)
        return (tuple(np.asarray(b) for b in t.result), commits,
                [r.stats for r in shell.regions])
    finally:
        shell.shutdown()


def _same(kernel, got, want):
    for a, b in zip(got, want):
        if kernel == "MedianBlur":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=GAUSS_TOL)


def _fields(committed) -> dict:
    ctx = committed.materialize().context
    return {f: np.asarray(getattr(ctx, f)) for f in FIELDS}


def _img(seed):
    return make_image(np.random.default_rng(seed), SIZE)


# ---------------------------------------------------------- single dispatch
def test_megakernel_single_dispatch_bit_identity():
    """An unpreempted launch is ONE launch regardless of budget, runs
    exactly the sync engine's chunk count, and its output is bitwise the
    port's sync and pipelined engines' and the reference megakernel's."""
    img = _img(7)
    sync, _, (s_stats,) = _run(PORT, img, engine="sync")
    pipe, _, _ = _run(PORT, img, engine="pipelined")
    mega, _, (m_stats,) = _run(PORT, img)
    ref, _, (r_stats,) = _run(REF, img)
    assert m_stats.megakernel_launches == r_stats.megakernel_launches == 1
    assert m_stats.flag_poll_exits == r_stats.flag_poll_exits == 0
    assert m_stats.chunks == s_stats.chunks == r_stats.chunks
    for other in (sync, pipe, ref):
        _same("MedianBlur", mega, other)


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_engine_mode_validation(side):
    with pytest.raises(ValueError, match="unknown engine mode"):
        side.Shell(n_regions=1, engine="warp-drive", prefetch=False,
                   devices=side.devices)


# ----------------------------------------------------- flag-timing coverage
def test_flag_at_every_boundary_same_region():
    """Arming the flag at boundary 1 of every launch preempts at EVERY
    chunk boundary; each resume is device-resident (no host spill), every
    commit's context equals the reference's, and the output is bitwise the
    uninterrupted sync run's."""
    img = _img(8)
    want, _, (s_stats,) = _run(PORT, img, engine="sync")
    n_chunks = s_stats.chunks
    assert n_chunks >= 3
    got, commits, (st,) = _run(PORT, img, arm=1, rearm=True)
    ref, ref_commits, (r_st,) = _run(REF, img, arm=1, rearm=True)
    pre = len(commits)
    assert pre == n_chunks - 1 == len(ref_commits)
    assert st.flag_poll_exits == pre == r_st.flag_poll_exits
    assert st.megakernel_launches == n_chunks == r_st.megakernel_launches
    assert st.chunks == n_chunks
    assert st.host_spills_avoided == pre == r_st.host_spills_avoided
    for mine, theirs in zip(commits, ref_commits):
        for f, v in _fields(theirs).items():
            np.testing.assert_array_equal(_fields(mine)[f], v, err_msg=f)
    _same("MedianBlur", got, want)
    _same("MedianBlur", got, ref)


def test_flag_exit_cross_region_materialize():
    """A flag-exited context resumed on a DIFFERENT region: the lazy
    commit materializes through the host, bitwise, at every boundary."""
    img = _img(9)
    want, _, (s_stats,) = _run(PORT, img, iters=3, engine="sync")
    for k in range(1, s_stats.chunks):
        got, commits, stats = _run(PORT, img, iters=3, arm=k,
                                   cross_region=True)
        assert len(commits) == 1
        assert stats[0].chunks == k  # exact boundary
        assert stats[0].flag_poll_exits == 1
        assert stats[1].host_spills_avoided == 0
        _same("MedianBlur", got, want)


@pytest.mark.parametrize("boundary", [1, 5])
def test_flag_exit_cross_shell_migration(boundary):
    """A RUNNING megakernel launch checkpoint-migrates across shells: the
    frontend's handoff preempts it through the flag at the boundary the
    driving thread chose (the plain loop's ``on_chunk`` holds the launch
    there until the migrator has asked), the commit spills through the
    checksummed checkpoint, and the launch resumed on the other shell
    finishes bitwise the uninterrupted sync run's and the reference
    megakernel's."""
    from repro_torch.cluster import ClusterFrontend

    img, iters = _img(11), 3
    want, _, (s_stats,) = _run(PORT, img, iters=iters, engine="sync",
                               budget=1)
    ref, _, _ = _run(REF, img, iters=iters, budget=1)
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1, chunk_budget=1,
                         rebalance=False, engine="megakernel",
                         prefetch=False, devices=PORT.devices)
    t = _task(PORT, img, iters=iters)
    reached, seen = threading.Event(), [0]

    def hold(region, task):
        if task is not t or reached.is_set():
            return
        seen[0] += 1
        if seen[0] == boundary:
            reached.set()
            deadline = time.perf_counter() + TIMEOUT
            while (not region._preempt.is_set()
                   and time.perf_counter() < deadline):
                time.sleep(0.001)

    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = hold
    try:
        h = fe.submit(t)
        assert reached.wait(TIMEOUT), "the launch never reached its hold"
        assert fe.migrate(tid=t.tid), "forced migration never completed"
        out = tuple(np.asarray(b) for b in h.result(timeout=TIMEOUT))
        assert h.n_migrations == 1 and h.node_history == [0, 1]
        src, dst = (n.shell.regions[0].stats for n in fe.nodes)
        assert src.flag_poll_exits == 1 and src.chunks == boundary
        assert src.megakernel_launches == dst.megakernel_launches == 1
        assert dst.flag_poll_exits == 0 and dst.host_spills_avoided == 0
        assert src.chunks + dst.chunks == s_stats.chunks
        _same("MedianBlur", out, want)
        _same("MedianBlur", out, ref)
    finally:
        rep = fe.shutdown()
    assert rep["stranded_handles"] == 0 and rep["lost_tasks"] == 0


@pytest.mark.parametrize("kernel", ["MedianBlur", "GaussianBlur"])
def test_flag_exit_context_equals_reference_at_every_boundary(kernel):
    """Parity: a launch armed at boundary ``k`` commits, field by field,
    the context the reference's megakernel commits at ``k``, and the
    partial images equal; the resumed run finishes equal too."""
    img = _img(10)
    _, _, (s_stats,) = _run(PORT, img, iters=3, kernel=kernel, engine="sync")
    for k in range(1, s_stats.chunks):
        runs = {}
        for side in SIDES:
            shell = _shell(side)
            try:
                t = _task(side, img, iters=3, kernel=kernel)
                commits = _drive(side, shell, t, arm=k)
                host = commits[0].materialize()
                runs[side.name] = (_fields(commits[0]),
                                   tuple(np.asarray(b)
                                         for b in host.payload[:2]),
                                   tuple(np.asarray(b) for b in t.result),
                                   shell.regions[0].stats.chunks)
            finally:
                shell.shutdown()
        (r_ctx, r_part, r_out, r_n), (p_ctx, p_part, p_out, p_n) = (
            runs["ref"], runs["port"])
        assert p_n == r_n
        for f in FIELDS:
            np.testing.assert_array_equal(p_ctx[f], r_ctx[f],
                                          err_msg=f"{f} at boundary {k}")
        assert p_ctx["done"] == 0
        _same(kernel, p_part, r_part)
        _same(kernel, p_out, r_out)


# ------------------------------------------------- (budget, preempt_at) prop
@pytest.fixture(scope="module")
def prop_shells():
    """A megakernel shell of each package shared across the corners, so
    the reference compiles each signature once; budgets vary through the
    per-task ``chunk_budget`` override (itself under test)."""
    shells = {side.name: _shell(side) for side in SIDES}
    yield shells
    for s in shells.values():
        s.shutdown()


# the deterministic corners of test_megakernel.py's property
@pytest.mark.parametrize("budget,preempt_at,iters,seed", [
    (1, 1, 1, 0), (1, 3, 2, 1), (2, 1, 2, 2), (3, 2, 3, 3),
    (4, 8, 1, 0), (2, 5, 3, 1),
])
def test_property_budget_preempt_bit_identity(prop_shells, budget,
                                              preempt_at, iters, seed):
    """Flag-preempting every launch at ``preempt_at`` under ``budget``
    gives the port the reference megakernel's output, preemption count and
    chunk count, and the port's own sync engine's output."""
    img = _img(seed)
    got = {}
    for side in SIDES:
        shell = prop_shells[side.name]
        chunks0 = shell.regions[0].stats.chunks
        t = _task(side, img, iters=iters)
        t.chunk_budget = budget
        commits = _drive(side, shell, t, arm=preempt_at, rearm=True)
        got[side.name] = (tuple(np.asarray(b) for b in t.result),
                          len(commits), shell.regions[0].stats.chunks - chunks0)
    assert got["port"][1:] == got["ref"][1:]
    _same("MedianBlur", got["port"][0], got["ref"][0])
    want, _, _ = _run(PORT, img, iters=iters, engine="sync", budget=budget)
    _same("MedianBlur", got["port"][0], want)


# --------------------------------------------------- stale-budget regression
def _mega_resume_chunks(resume_budget):
    """Preempt a budget-4 launch at its first boundary, override the task
    budget, resume to completion.  Returns (first-launch chunks, resumed
    chunks, result, image)."""
    shell = _shell(PORT, chunk_budget=4)
    try:
        img = _img(3)
        t = _task(PORT, img, iters=2)
        r = shell.regions[0]
        r.enqueue_reconfig(t)
        t.preempt_at_boundary = 1
        r.enqueue_launch(t)
        deadline = time.perf_counter() + TIMEOUT
        while t.status is not P_task.TaskStatus.PREEMPTED:
            assert time.perf_counter() < deadline
            time.sleep(0.0005)
        first = r.stats.chunks
        t.chunk_budget = resume_budget
        r.cancel_preempt()
        r.enqueue_launch(t)
        while t.status is not P_task.TaskStatus.DONE:
            assert time.perf_counter() < deadline
            time.sleep(0.0005)
        return (first, r.stats.chunks - first,
                tuple(np.asarray(b) for b in t.result), img)
    finally:
        shell.shutdown()


def test_stale_budget_reuploads_on_resume():
    """A task requeued with a SMALLER budget after a flag exit runs its
    resumed launch in more, smaller chunks (the budget goes to each launch
    by value), and the result stays bitwise the reference's sync run's."""
    first_a, resumed_default, out_default, img = _mega_resume_chunks(None)
    first_b, resumed_small, out_small, _ = _mega_resume_chunks(1)
    assert first_a == first_b == 1  # deterministic boundary placement
    assert resumed_small > resumed_default
    ref, _, _ = _run(REF, img, engine="sync", budget=4)
    _same("MedianBlur", out_default, ref)
    _same("MedianBlur", out_small, ref)


def test_task_budget_override_sync_engine():
    """``task.chunk_budget`` is resolved freshly per launch on every
    engine, as in the reference."""
    img = _img(4)
    counts = {}
    for side in SIDES:
        for budget in (None, 1):
            shell = _shell(side, engine="sync", chunk_budget=4)
            try:
                t = _task(side, img)
                t.chunk_budget = budget
                _drive(side, shell, t)
                counts[side.name, budget] = shell.regions[0].stats.chunks
            finally:
                shell.shutdown()
    assert counts["port", 1] > counts["port", None]
    assert counts["port", 1] == counts["ref", 1]
    assert counts["port", None] == counts["ref", None]


# ------------------------------------------------------------ backoff wait
class _Snap:
    """Not ready for ``n`` polls, then ready (``is_ready`` for the
    reference's snapshots, ``query`` for the port's events and launches)."""

    def __init__(self, n):
        self.n = n

    def is_ready(self):
        self.n -= 1
        return self.n < 0

    query = is_ready


def _check_backoff(delays, floor, cap):
    assert delays[0] == pytest.approx(floor)
    for a, b in zip(delays, delays[1:]):
        assert b == pytest.approx(min(a * 2.0, cap))
    assert max(delays) <= cap
    assert delays[-1] == pytest.approx(cap)


@pytest.mark.parametrize("wait", ["chunk_event", "megakernel_launch"])
def test_wait_ready_exponential_backoff(monkeypatch, wait):
    """The wait starts at the floor, doubles per wakeup and saturates at
    the cap, with the reference's constants: for a chunk's event and for a
    megakernel launch in flight."""
    assert (P_region._POLL_MIN_S, P_region._POLL_MAX_S) == (
        R_region._POLL_MIN_S, R_region._POLL_MAX_S)
    shell = _shell(PORT, engine="sync" if wait == "chunk_event"
                   else "megakernel")
    try:
        delays = []
        monkeypatch.setattr(P_region.time, "sleep",
                            lambda s: delays.append(s))
        region = shell.regions[0]
        if wait == "chunk_event":
            region._wait_ready(_Snap(12), abort_on_preempt=False)
        else:
            t = _task(PORT, _img(6))
            bufs = tuple(torch.tensor(b) for b in t.args.bufs[:2])
            done = P_Ctx.fresh()._replace(done=1)

            class Launch(_Snap):
                def result(self):
                    return done, bufs, 3

            region.executable = lambda *a, **kw: Launch(12)
            region._launch_megakernel(t, P_kernels.get_kernel("MedianBlur"),
                                      2, None, None, P_Ctx.fresh(), bufs,
                                      time.perf_counter())
            assert region.stats.megakernel_launches == 1
            assert region.stats.chunks == 3
        _check_backoff(delays, P_region._POLL_MIN_S, P_region._POLL_MAX_S)
    finally:
        shell.shutdown()


# --------------------------------------------------------- report counters
@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_scheduler_report_counters_and_schema(side):
    shell = _shell(side)
    sched = side.Scheduler(shell, side.SchedulerConfig())
    tasks = [_task(side, _img(5 + i), iters=1) for i in range(2)]
    rep = sched.run(tasks, quiet=True)
    shell.shutdown()
    assert rep["megakernel_launches"] >= 2
    assert rep["flag_poll_exits"] == 0
    unknown = set(rep) - set(SCHEMA["scheduler"])
    assert not unknown, f"undocumented scheduler report keys: {unknown}"
    for r in shell.reconfig_report()["regions"].values():
        assert "megakernel_launches" in r and "flag_poll_exits" in r


def test_mega_program_is_its_own_bitstream():
    """``"mega"`` keys its own cache entry beside ``"chunk"``, in the
    reference's key layout, and the prefetcher of a megakernel shell warms
    it."""
    shell = _shell(PORT)
    try:
        assert shell.prefetcher.program == "mega"
        t = _task(PORT, _img(2))
        shell.engine.prewarm("MedianBlur", t.args, (1,), program="mega")
        shell.engine.prewarm("MedianBlur", t.args, (1,), program="chunk")
        keys = shell.engine.cache.keys()
        assert [k[3] for k in keys] == ["mega", "chunk"]
        assert keys[0] == R_reconfig.ReconfigEngine().cache_key(
            "MedianBlur", t.args.signature(), (1,), "mega")
        with pytest.raises(ValueError, match="unknown program"):
            shell.engine.prewarm("MedianBlur", t.args, (1,), program="x")
    finally:
        shell.shutdown()
    assert _shell(PORT, engine="pipelined").prefetcher.program == "chunk"


# ------------------------------------------ the persistent entry's contract
def test_context_words_layout():
    """``to_words`` lays the record out as ``csrc/blur.cu``'s ``struct
    Ctx``: the four arrays, then valid, done, budget, intr."""
    rng = np.random.default_rng(0)
    ctx = P_Ctx(*(rng.integers(-9, 9, 8).astype(np.int32) for _ in range(4)),
                valid=1, done=0, budget=-1, intr=1)
    w = ctx.to_words()
    assert w.dtype == np.int32 and w.shape == (CTX_WORDS,) == (36,)
    np.testing.assert_array_equal(w[:8], ctx.var)
    np.testing.assert_array_equal(w[24:32], ctx.saved)
    assert list(w[32:]) == [1, 0, -1, 1]
    back = P_Ctx.from_words(w)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(ctx, f))


@pytest.mark.parametrize("kernel", ["MedianBlur", "GaussianBlur"])
@pytest.mark.parametrize("budget,flag", [(1, 0), (2, 3), (8, 1), (3, 0)])
def test_blur_mega_plain_version_equals_reference_megakernel(kernel, budget,
                                                             flag):
    """``ops.blur_mega`` on CPU tensors (the persistent entry's plain
    version) against the reference's ``make_megakernel`` over the same
    task body, called directly, launch after launch to completion: the
    context fields and chunk count after each launch, and the images."""
    iters = 3
    img = _img(11)
    kind = "median" if kernel == "MedianBlur" else "gaussian"
    r_kd = R_kernels.get_kernel(kernel)
    r_bufs, r_ints, r_floats = r_kd.bundle(
        img.copy(), np.zeros_like(img), H=SIZE, W=SIZE, iters=iters).padded()
    r_mega = R_pre.make_megakernel(r_kd.fn)
    r_flag = R_pre.PreemptFlag()
    r_state = tuple(jnp.asarray(b) for b in r_bufs)
    r_ctx = R_Ctx.fresh()
    p_flag = P_pre.PreemptFlag()
    ping, pong = torch.tensor(img), torch.zeros(img.shape)
    words = P_Ctx.fresh().to_words()
    for launch in range(100):
        r_flag.write(flag)
        p_flag.write(flag)
        r_ctx, r_state, r_done, r_n = r_mega(r_ctx, r_state, r_ints, r_floats,
                                             jnp.int32(budget), r_flag.device)
        words, n = P_ops.blur_mega(words, ping, pong, kind, iters, budget,
                                   p_flag).result()
        assert n == int(r_n), f"launch {launch}"
        got = P_Ctx.from_words(words)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(r_ctx, f)),
                                          err_msg=f"{f}, launch {launch}")
        _same(kernel, (ping.numpy(), pong.numpy()),
              tuple(np.asarray(b) for b in r_state[:2]))
        if int(r_done):
            break
    assert got.done == 1
    if flag == 0:
        assert launch == 0  # one launch runs the whole task


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return P_pre.MegaDone(args[0], None, 0)


def test_cuda_region_binds_only_the_persistent_entry():
    """On a CUDA device ``make_megakernel`` binds ``KernelDef.mega`` and
    never the host loop: the launch hands the entry the context words and
    the budget by value, and the task body is not called."""
    kd = P_kernels.get_kernel("MedianBlur")
    assert kd.mega is not None
    entry = _Recorder()

    def body(*args):
        raise AssertionError("the host loop ran on a CUDA device")

    fake = P_kernels.KernelDef(name="Fake", backend="PYNQ", fn=body,
                               ktile_args=(), int_args=(), float_args=(),
                               mega=entry)
    ctx = P_Ctx.fresh()._replace(budget=5)
    mega = P_pre.make_megakernel(fake, torch.device("cuda", 0))
    mega(ctx, ("ping", "pong"), "ints", "floats", np.int64(2), "flag")
    (words, bufs, ints, floats, budget, flag), = entry.calls
    np.testing.assert_array_equal(words, ctx.to_words())
    assert (bufs, ints, floats, budget, flag) == (
        ("ping", "pong"), "ints", "floats", 2, "flag")
    assert type(budget) is int


@pytest.mark.parametrize("library", [None, "flash_attention"])
def test_kernels_without_a_persistent_entry_raise_on_the_card(library,
                                                              monkeypatch):
    """A kernel registered without ``mega=`` (one whose chunk body runs
    plain torch, and one that launches a CUDA kernel a chunk): on a CUDA
    engine the ``"mega"`` program raises at reconfig (before any build),
    and nothing falls back to the host loop.  On the CPU the plain version
    binds it, as the reference's CPU backend does."""
    name = f"NoPersistentEntry_{library}"
    # registered for this test only
    monkeypatch.setitem(P_kernels._REGISTRY, name, None)

    @P_kernels.ctrl_kernel(name, backend="PYNQ", ktile_args=("x",),
                           library=library)
    def body(ctx, bufs, ints, floats):
        return ctx.finish(), bufs

    kd = P_kernels.get_kernel(name)
    assert kd.mega is None
    engine = ReconfigEngine(device=torch.device("cuda", 0))
    with pytest.raises(NotImplementedError, match="has none"):
        engine._compile(kd, None, None, program="mega")
    assert callable(P_pre.make_megakernel(kd, torch.device("cpu")))


# ------------------------------------- M2/M3, the surrogate LM's entries
def _seq_inputs(kernel, d_model, vocab, seed=0):
    """One task's bundle (numpy) for ``kernel``: a 7-token prompt padded to
    16 for ``SeqPrefill``; for ``SeqDecode`` 4 slot rows of 5 steps: a
    live row, one of 3 tokens, an inactive one and one of 0 tokens."""
    from repro_torch.serving.kernels import init_state

    rng = np.random.default_rng(seed)
    if kernel == "SeqPrefill":
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :7] = rng.integers(0, vocab, 7)
        state = init_state(seed, d_model)[None, :]
        return ((np.zeros((1, 8), np.int32), state, prompt),
                dict(P=16, D=d_model, vocab=vocab, prompt_len=7))
    S, R = 4, 5
    state = rng.integers(-2**31, 2**31, (S, d_model),
                         dtype=np.int64).astype(np.int32)
    slots = np.zeros((S, 8), np.int32)
    slots[:, 0] = (1, 1, 0, 1)                      # active
    slots[:, 1] = (R, 3, R, 0)                      # n_emit
    slots[:, 2] = rng.integers(0, vocab, S)         # last token
    out = np.full((S, R), -1, np.int32)
    return ((out, state, slots), dict(S=S, D=d_model, R=R, vocab=vocab))


@pytest.mark.parametrize("s,d,compute,rows_per_warp,resident", [
    (1, 384, 1, 1, True),        # M2 at the surrogate's width
    (31, 384, 31, 1, True),      # a row a warp, 31 of them and the watcher
    (32, 384, 16, 2, True),      # M3 on the decode main path: 48 KiB
    (128, 384, 26, 5, True),     # the most slots, still resident
    (65, 100, 22, 3, True),
    (56, 1000, 28, 2, True),     # 224000 bytes: under the cap
    (64, 896, 22, 3, True),      # exactly the cap
    (128, 1000, 26, 5, False),   # over it: the rows stay in global memory
    (1, 57345, 1, 1, False),     # M2's one row over it
])
def test_seq_mega_plan(s, d, compute, rows_per_warp, resident):
    """M2/M3's launch geometry and residency (``kernels/seq_lm/kernel.py``
    ``plan``, which the wrappers pass to ``csrc/seq_lm.cu``): a warp a row
    up to 31 rows, else the fewest rows a warp that fit in 31 warps, one
    more warp to read the flag, the rows in shared memory while their bytes
    fit in ``RESIDENT_BYTES``."""
    from repro_torch.kernels.seq_lm import kernel as QK

    got = QK.plan(s, d)
    assert got == {"warps": compute + 1, "compute_warps": compute,
                   "rows_per_warp": rows_per_warp, "resident": resident,
                   "smem_bytes": s * d * 4 if resident else 0}
    assert compute * rows_per_warp >= s > (compute - 1) * rows_per_warp
    assert got["warps"] <= QK.MAX_WARPS
    assert got["smem_bytes"] <= QK.RESIDENT_BYTES


@pytest.mark.parametrize("s,d", [(0, 384), (129, 384), (32, 0)])
def test_seq_mega_plan_rejects_what_no_launch_takes(s, d):
    from repro_torch.kernels.seq_lm import kernel as QK

    with pytest.raises(ValueError, match="at most 128"):
        QK.plan(s, d)


def _seq_mega_port(kernel, words, bufs, scalars, budget, flag):
    from repro_torch.kernels.seq_lm import ops as SQ

    if kernel == "SeqPrefill":
        return SQ.seq_prefill_mega(words, *bufs, scalars["prompt_len"],
                                   scalars["vocab"], budget, flag).result()
    return SQ.seq_decode_mega(words, *bufs, scalars["vocab"], budget,
                              flag).result()


@pytest.mark.parametrize("kernel", ["SeqPrefill", "SeqDecode"])
@pytest.mark.parametrize("budget", [1, 2, 4])
@pytest.mark.parametrize("d_model,vocab", [(16, 101), (64, 51865)])
def test_seq_mega_plain_version_equals_reference_megakernel(kernel, budget,
                                                            d_model, vocab):
    """``kernels.seq_lm.ops`` on CPU tensors (M2/M3's plain version)
    against the reference's ``make_megakernel`` over ``seq_prefill`` /
    ``seq_decode``, called directly, launch after launch to completion,
    with the flag at every boundary (0: one launch runs the task): every
    context field, the chunk count and every buffer bitwise after each
    launch."""
    import jax

    bufs, scalars = _seq_inputs(kernel, d_model, vocab)
    r_kd = R_kernels.get_kernel(kernel)
    r_mega = jax.jit(R_pre.make_megakernel(r_kd.fn))
    r_flag = R_pre.PreemptFlag()
    p_flag = P_pre.PreemptFlag()
    steps = 7 if kernel == "SeqPrefill" else 5
    for flag in range(0, -(-steps // budget) + 2):
        r_bufs, r_ints, r_floats = r_kd.bundle(
            *(b.copy() for b in bufs), **scalars).padded()
        r_state = tuple(jnp.asarray(b) for b in r_bufs)
        r_ctx = R_Ctx.fresh()
        mine = tuple(torch.tensor(b) for b in bufs)
        words = P_Ctx.fresh().to_words()
        for launch in range(100):
            r_flag.write(flag)
            p_flag.write(flag)
            r_ctx, r_state, r_done, r_n = r_mega(
                r_ctx, r_state, r_ints, r_floats, jnp.int32(budget),
                r_flag.device)
            words, n = _seq_mega_port(kernel, words, mine, scalars, budget,
                                      p_flag)
            where = f"flag {flag}, launch {launch}"
            assert n == int(r_n), where
            assert p_flag.progress() == n, where
            got = P_Ctx.from_words(words)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f), np.asarray(getattr(r_ctx, f)),
                    err_msg=f"{f}, {where}")
            for a, b in zip(mine, r_state[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=where)
            if int(r_done):
                break
        assert got.done == 1
        if flag == 0 or flag > -(-steps // budget):
            assert launch == 0  # one launch runs the whole task


@pytest.mark.parametrize("kernel", ["SeqPrefill", "SeqDecode"])
def test_seq_kernels_bind_their_persistent_entry(kernel):
    """``SeqPrefill``/``SeqDecode`` carry their persistent entries (M2/M3,
    built from ``csrc/seq_lm.cu`` with the ``"mega"`` program): on a CUDA
    device ``make_megakernel`` binds them without raising, and the bound
    launch hands the context words, buffers, ``prompt_len``/``vocab`` and
    the budget to ``kernels.seq_lm.ops``, which (given CPU tensors here)
    runs the plain version: its context, chunks and buffers equal the host
    loop's."""
    kd = P_kernels.get_kernel(kernel)
    assert kd.mega is not None and kd.mega_library == "seq_lm"
    assert kd.library is None  # the chunk body launches no CUDA kernel
    bufs, scalars = _seq_inputs(kernel, 32, 51865, seed=5)
    _, ints, floats = kd.bundle(*bufs, **scalars).padded()
    flag = P_pre.PreemptFlag()
    flag.write(2)
    mine = tuple(torch.tensor(b) for b in bufs)
    ctx, got, n = P_pre.make_megakernel(kd, torch.device("cuda", 0))(
        P_Ctx.fresh(), mine, ints, floats, 1, flag).result()
    plain = tuple(torch.tensor(b) for b in bufs)
    want_ctx, _, want_n = P_pre.make_megakernel(kd)(
        P_Ctx.fresh(), plain, ints, floats, 1, flag).result()
    assert got is mine and n == want_n == 2 and ctx.done == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ctx, f), getattr(want_ctx, f))
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)


def test_serving_probe_arms_the_flag_in_megakernel_mode():
    """In megakernel mode the serving engine's preempt probe arms each
    round's one-shot flag boundary (the reference's
    ``_maybe_probe_preempt``): decode rounds exit on the flag and resume,
    and every stream still equals the surrogate oracle, bitwise."""
    from repro_torch import Client
    from repro_torch.serving.kernels import oracle_stream

    d_model, vocab = 16, 101
    with Client(n_regions=2, device="cpu", engine="megakernel",
                chunk_budget=1, prefetch=False,
                serving=dict(d_model=d_model, vocab_size=vocab,
                             round_tokens=4, preempt_probe_every=1,
                             decode_regions=(1,))) as client:
        rng = np.random.default_rng(3)
        specs = [([int(x) for x in rng.integers(0, vocab, size=3)], i)
                 for i in range(3)]
        handles = [client.stream(p, max_new_tokens=8, seed=s)
                   for p, s in specs]
        for h, (prompt, seed) in zip(handles, specs):
            assert h.result(timeout=TIMEOUT) == oracle_stream(
                prompt, seed, 8, d_model, vocab)
        rep = client.serving_report()
        sched = client.report()
    assert rep["decode_preemptions"] >= 1
    assert rep["stranded_sequences"] == 0
    assert sched["flag_poll_exits"] >= 1
    assert sched["megakernel_launches"] > sched["flag_poll_exits"]
