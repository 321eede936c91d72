"""The port's scheduler layers against the reference's: the invariants of
``tests/test_scheduler_properties.py``, the policy and admission layer of
``tests/test_policy_layer.py`` (with the coalescing lookahead of
``tests/test_chunk_pipeline.py``), and the reconfiguration subsystem of
``tests/test_reconfig_cache.py``.

Policies, caches and engines are fed the same sequences in both packages
in this process; the selection order, victims, virtual times, cache keys
and counters must agree.  Whole scheduler runs go through the port on the
same seeded numpy inputs as the reference's tests, and every image is held
against the reference's oracle (median bitwise, gaussian within 1e-6).
The reference's hypothesis properties become fixed parametrised grids;
its wall-clock preemption test becomes a twin in which the arrivals land
at a chunk boundary of the running task, in both packages alike (the
port's regions call ``on_chunk``; the reference's have no such hook, so
the test wraps their per-iteration failure check, which the worker calls
at the top of its chunk loop, right after each retired chunk).

Covered elsewhere, not repeated: chunked execution at every budget against
the reference's context fields after every chunk
(``test_torch_context.py::test_context_fields_match_reference_after_every_chunk``)
and the single-region version of the strictly-lower-priority twin
(``test_torch_client.py::test_priority_preemption_is_deterministic``).
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
from repro.core import policy as R_policy  # noqa: E402
from repro.core import prefetch as R_prefetch  # noqa: E402
from repro.core import reconfig as R_reconfig  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import submit as R_submit  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro_torch.controller import kernels as P_kernels  # noqa: E402
from repro_torch.core import policy as P_policy  # noqa: E402
from repro_torch.core import prefetch as P_prefetch  # noqa: E402
from repro_torch.core import reconfig as P_reconfig  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import submit as P_submit  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

SIZE = 128  # pads to [130, 130]: 4 row blocks a pass
TIMEOUT = 60.0
GAUSS_TOL = 1e-6
KINDS = {"MedianBlur": "median", "GaussianBlur": "gaussian"}


def _ref_on_chunk(region, hook):
    """Call ``hook(region, task)`` on the reference region's worker after
    each retired chunk, from a wrapper around the failure check at the
    top of its chunk loop."""
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
    name="ref", policy=R_policy, submit=R_submit, reconfig=R_reconfig,
    prefetch=R_prefetch, Task=R_task.Task, TaskStatus=R_task.TaskStatus,
    Shell=R_shell.Shell, Scheduler=R_scheduler.Scheduler,
    SchedulerConfig=R_scheduler.SchedulerConfig,
    get_kernel=R_kernels.get_kernel, default=None, on_chunk=_ref_on_chunk)
PORT = SimpleNamespace(
    name="port", policy=P_policy, submit=P_submit, reconfig=P_reconfig,
    prefetch=P_prefetch, Task=P_task.Task, TaskStatus=P_task.TaskStatus,
    Shell=P_shell.Shell, Scheduler=P_scheduler.Scheduler,
    SchedulerConfig=P_scheduler.SchedulerConfig,
    get_kernel=P_kernels.get_kernel, default=["cpu"],
    on_chunk=_port_on_chunk)
SIDES = (REF, PORT)


def _oracle(img, iters, kernel):
    return np.asarray(iterated_blur_ref(jnp.asarray(img), iters,
                                        KINDS[kernel]))


def _check(kernel, got, want):
    if kernel == "MedianBlur":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_TOL)


def _check_task(task, img=None):
    iters = int(task.args.ints[2])
    img = np.asarray(task.args.bufs[0]) if img is None else img
    _check(task.kernel, task.result[iters % 2],
           _oracle(img, iters, task.kernel))


def _blur(side, img, iters=1, kernel="MedianBlur", **kw):
    kd = side.get_kernel(kernel)
    return side.Task(kernel=kernel,
                     args=kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                    W=SIZE, iters=iters), **kw)


def _wait_for(cond, timeout=TIMEOUT, dt=0.005):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return cond()


# ------------------------------------------------------ policies in lockstep
class _Args:
    """Stand-in ArgBundle: policies only ever call ``signature()``."""

    def signature(self):
        return ("sig",)


class _FakeRegion:
    def __init__(self, rid, loaded=None):
        self.rid = rid
        self.loaded = loaded
        self.geometry = (1,)
        self.current_task = None


def _pair(**fields):
    """The same queued task in both packages: (reference, port)."""
    out = []
    for side in SIDES:
        t = side.Task(kernel="K", args=_Args(), **fields)
        t.status = side.TaskStatus.QUEUED
        out.append(t)
    return tuple(out)


def _policies(name, **kw):
    return (R_policy.make_policy(name, **kw), P_policy.make_policy(name, **kw))


def _enqueue(pols, pairs):
    for ref, port in pairs:
        pols[0].enqueue(ref)
        pols[1].enqueue(port)


def _drain(pol, regions=None):
    regions = regions or [_FakeRegion(0)]
    out = []
    while True:
        pick = pol.select(regions)
        if pick is None:
            return out
        out.append(pick[0])


def _drain_both(pols, pairs):
    """Drain both policies; the dispatch orders (as indices into
    ``pairs``) must agree."""
    index = [{id(p[i]): k for k, p in enumerate(pairs)} for i in (0, 1)]
    orders = [[index[i][id(t)] for t in _drain(pols[i])] for i in (0, 1)]
    assert orders[1] == orders[0]
    assert not pols[1].has_pending()
    return orders[1]


@pytest.mark.parametrize("seed", range(8))
def test_fcfs_order_matches_reference(seed):
    """Priority-major, arrival-minor, submission-stable for ties: the
    seed scheduler's exact order, in both packages."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    specs = list(zip(rng.integers(0, 5, n).tolist(),
                     rng.uniform(0, 10, n).tolist()))
    if seed % 2:  # ties on arrival too
        specs = [(p, float(int(a))) for p, a in specs]
    pairs = [_pair(priority=p, arrival_time=a) for p, a in specs]
    pols = _policies("fcfs", n_priorities=5)
    _enqueue(pols, pairs)
    order = _drain_both(pols, pairs)
    keys = [(specs[k][0], specs[k][1], k) for k in order]
    assert keys == sorted(keys)


def test_fcfs_requeued_preempted_task_keeps_arrival_slot():
    """A preempted task re-enters FCFS at its original arrival position,
    ahead of later arrivals at the same priority."""
    early, late = _pair(priority=2, arrival_time=0.1), _pair(
        priority=2, arrival_time=0.9)
    pols = _policies("fcfs", n_priorities=5)
    for i in (0, 1):
        pols[i].enqueue(late[i])
        pols[i].on_requeue(early[i])  # came back after a preemption
    assert _drain_both(pols, [early, late]) == [0, 1]


def _victim(pols, candidate, running):
    """Victim index chosen by both policies among ``running`` (fields of
    the tasks on three fake regions)."""
    got = []
    for i, side in enumerate(SIDES):
        regions = [_FakeRegion(k) for k in range(len(running))]
        for r, fields in zip(regions, running):
            r.current_task = _pair(**fields)[i]
        v = pols[i].choose_victim(_pair(**candidate)[i], regions)
        got.append(None if v is None else v.rid)
    assert got[1] == got[0]
    return got[1]


def test_fcfs_victim_rule_matches_reference():
    """Victim: first region running the numerically-largest
    strictly-lower priority; equal priority is never preempted."""
    pols = _policies("fcfs", n_priorities=5)
    running = [{"priority": 2}, {"priority": 4}, {"priority": 4}]
    assert _victim(pols, {"priority": 1}, running) == 1
    assert _victim(pols, {"priority": 4}, running) is None


def test_fcfs_affinity_prefers_matching_bitstream():
    pols = _policies("fcfs", n_priorities=5)
    got = []
    for i in (0, 1):
        pols[i].enqueue(_pair(priority=0)[i])
        plain, warm = _FakeRegion(0), _FakeRegion(1, loaded=("K", ("sig",),
                                                             (1,)))
        got.append(pols[i].select([plain, warm])[1].rid)
    assert got == [1, 1]


@pytest.mark.parametrize("seed", range(8))
def test_edf_order_matches_reference(seed):
    """Earliest deadline first; deadline-less tasks run last."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 40))
    deadlines = [None if rng.uniform() < 0.2 else float(rng.uniform(0, 100))
                 for _ in range(n)]
    pairs = [_pair(deadline_s=d) for d in deadlines]
    pols = _policies("edf", n_priorities=5)
    _enqueue(pols, pairs)
    order = _drain_both(pols, pairs)
    key = [deadlines[k] if deadlines[k] is not None else float("inf")
           for k in order]
    assert key == sorted(key)


def test_edf_victim_has_strictly_later_deadline():
    pols = _policies("edf", n_priorities=5)
    running = [{"deadline_s": 5.0}, {"deadline_s": 9.0}]
    assert _victim(pols, {"deadline_s": 1.0}, running) == 1
    assert _victim(pols, {"deadline_s": 20.0}, running) is None
    assert _victim(pols, {"deadline_s": None}, running) is None


def test_edf_equal_deadlines_never_churn():
    """Two background (no-deadline) tasks never preempt each other, nor
    do two equal deadlines."""
    pols = _policies("edf", n_priorities=5)
    assert _victim(pols, {"deadline_s": None, "arrival_time": 1.0},
                   [{"deadline_s": None, "arrival_time": 2.0}]) is None
    assert _victim(pols, {"deadline_s": 5.0, "arrival_time": 1.0},
                   [{"deadline_s": 5.0, "arrival_time": 2.0}]) is None


def _wfq_both(pols, pairs):
    order = _drain_both(pols, pairs)
    assert pols[1]._vt == pytest.approx(pols[0]._vt, abs=0)
    return order


@pytest.mark.parametrize("n_flood,n_light", [(5, 1), (17, 3), (40, 5),
                                             (12, 5)])
def test_wfq_adversarial_matches_reference(n_flood, n_light):
    """A flooding tenant cannot starve a light one: while the light
    tenant is backlogged it gets one grant in every two, the same grants
    and virtual times in both packages."""
    pairs = ([_pair(tenant="flood") for _ in range(n_flood)]
             + [_pair(tenant="light") for _ in range(n_light)])
    pols = _policies("wfq", n_priorities=5)
    _enqueue(pols, pairs)
    order = ["flood" if k < n_flood else "light"
             for k in _wfq_both(pols, pairs)]
    last_light = max(i for i, t in enumerate(order) if t == "light")
    light_seen = 0
    for i, tenant in enumerate(order[:last_light + 1]):
        light_seen += tenant == "light"
        assert light_seen >= (i + 1) // 2 - 1
    assert order[:2 * n_light].count("flood") <= n_light + 1


def test_wfq_weights_bias_grants():
    pols = _policies("wfq", n_priorities=5,
                     tenant_weights={"big": 3.0, "small": 1.0})
    pairs = []
    for _ in range(30):
        pairs += [_pair(tenant="big"), _pair(tenant="small")]
    _enqueue(pols, pairs)
    first12 = [pairs[k][1].tenant for k in _wfq_both(pols, pairs)][:12]
    assert first12.count("big") == 9 and first12.count("small") == 3


def test_wfq_late_tenant_cannot_monopolise_after_drained_tenant():
    pols = _policies("wfq", n_priorities=5)
    first = [_pair(tenant="A") for _ in range(10)]
    _enqueue(pols, first)
    _wfq_both(pols, first)  # A consumed 10 grants; its queue is empty
    later = ([_pair(tenant="B") for _ in range(5)]
             + [_pair(tenant="A") for _ in range(5)])
    _enqueue(pols, later)
    order = [later[k][1].tenant for k in _wfq_both(pols, later)]
    assert order[:5].count("B") < 5  # no 5-grant monopoly for the newcomer
    assert "A" in order[:3]


def test_wfq_idle_tenant_banks_no_credit():
    pols = _policies("wfq", n_priorities=5)
    busy = [_pair(tenant="busy") for _ in range(10)]
    _enqueue(pols, busy)
    for pol in pols:
        for _ in range(6):
            pol.select([_FakeRegion(0)])
    assert pols[1]._vt == pytest.approx(pols[0]._vt, abs=0)
    late = [_pair(tenant="late") for _ in range(4)]
    _enqueue(pols, late)
    got = [[t.tenant for t in _drain(pol)] for pol in pols]
    assert got[1] == got[0]
    assert got[1][:8].count("late") <= 5  # alternates, no burst


def test_make_policy_registry():
    for side in SIDES:
        mk = side.policy.make_policy
        assert mk("fcfs", n_priorities=5).name == "fcfs"
        assert mk("EDF", n_priorities=5).name == "edf"
        assert mk("wfq", n_priorities=5,
                  tenant_weights={"a": 2.0}).weights == {"a": 2.0}
        with pytest.raises(ValueError, match="unknown scheduling policy"):
            mk("srpt", n_priorities=5)
    assert P_policy.POLICY_NAMES == R_policy.POLICY_NAMES


# ------------------------------------------------- coalescing lookahead
def _blur_pair(rng, kernel="MedianBlur", **fields):
    img = make_image(rng, SIZE)
    return tuple(_blur(side, img, kernel=kernel, **fields) for side in SIDES)


def _match(kernel):
    return lambda t: t.kernel == kernel


class _BareRegion:
    devices = None
    loaded = None


def _peek_both(pols, pairs, kernel):
    got = []
    for i in (0, 1):
        t = pols[i].peek_same_bitstream(_match(kernel), _BareRegion(), 8)
        got.append(None if t is None else
                   next(k for k, p in enumerate(pairs) if p[i] is t))
    assert got[1] == got[0]
    return got[1]


def _take_both(pols, pair):
    assert pols[0].take(pair[0]) and pols[1].take(pair[1])


def test_fcfs_peek_same_bitstream_semantics():
    rng = np.random.default_rng(14)
    pols = _policies("fcfs", n_priorities=5)
    pairs = [_blur_pair(rng, "GaussianBlur", priority=0),
             _blur_pair(rng, "MedianBlur", priority=3)]
    _enqueue(pols, pairs)
    # level 0 owns the region: no cross-level coalescing
    assert _peek_both(pols, pairs, "MedianBlur") is None
    _take_both(pols, pairs[0])
    assert _peek_both(pols, pairs, "MedianBlur") == 1
    _take_both(pols, pairs[1])
    assert not pols[1].has_pending()


def test_edf_peek_never_skips_a_deadline():
    rng = np.random.default_rng(15)
    pols = _policies("edf", n_priorities=5)
    pairs = [_blur_pair(rng, "GaussianBlur", deadline_s=5.0),
             _blur_pair(rng, "GaussianBlur"), _blur_pair(rng, "MedianBlur")]
    _enqueue(pols, pairs)
    assert _peek_both(pols, pairs, "MedianBlur") is None
    _take_both(pols, pairs[0])
    # background tasks may jump other background tasks
    assert _peek_both(pols, pairs, "MedianBlur") == 2


def test_wfq_peek_respects_tenant_turn_and_charges_vt():
    rng = np.random.default_rng(16)
    pols = _policies("wfq", n_priorities=5)
    pairs = [_blur_pair(rng, "MedianBlur", tenant="a"),
             _blur_pair(rng, "GaussianBlur", tenant="a"),
             _blur_pair(rng, "MedianBlur", tenant="a"),
             _blur_pair(rng, "MedianBlur", tenant="b")]
    _enqueue(pols, pairs)
    assert _peek_both(pols, pairs, "MedianBlur") == 0
    _take_both(pols, pairs[0])
    assert pols[1]._vt == pols[0]._vt and pols[1]._vt["a"] > 0
    # now it is b's turn: a's deeper Median must not be offered
    assert _peek_both(pols, pairs, "MedianBlur") == 3
    _take_both(pols, pairs[3])
    # back to a: intra-tenant FIFO may bend (the Median jumps the Gaussian)
    assert _peek_both(pols, pairs, "MedianBlur") == 2


# ------------------------------------------------- admission and handles
def test_task_handle_lifecycle_and_cancel_unit():
    """SubmissionQueue/TaskHandle without a scheduler: the same status
    transitions, cancel-while-queued and cancel-after-claim refusal."""
    seen = []
    for side in SIDES:
        sq = side.submit.SubmissionQueue()
        t = side.Task(kernel="K", args=_Args())
        h = sq.submit(t)
        steps = [h.status.value, h.done()]
        [(t2, h2)] = sq.drain_new()
        assert t2 is t and h2 is h
        steps += [h._back_to_queue(), h.status.value, h._claim(),
                  h.cancel(), h._back_to_queue(), h.cancel(), h.cancelled(),
                  h.done(), t.status.value]
        with pytest.raises(side.submit.CancelledError):
            h.result(timeout=0.1)
        steps.append(h._back_to_queue())
        sq.close()
        with pytest.raises(RuntimeError, match="closed"):
            sq.submit(side.Task(kernel="K", args=_Args()))
        seen.append(steps)
    assert seen[1] == seen[0]
    assert seen[1] == ["pending", False, True, "queued", True, False, True,
                       True, True, True, "cancelled", False]


def test_scheduler_rejects_bad_config():
    shell = P_shell.Shell(n_regions=1, devices=["cpu"])
    rshell = R_shell.Shell(n_regions=1)
    try:
        for bad, exc in ((P_scheduler.SchedulerConfig(n_priorities=0),
                          ValueError),
                         (P_scheduler.SchedulerConfig(policy="lottery"),
                          ValueError),
                         (P_scheduler.SchedulerConfig(
                             policy="wfq", tenant_weights={"a": 0.0}),
                          ValueError),
                         ({"preemption": True}, TypeError)):
            with pytest.raises(exc) as port_err:
                P_scheduler.Scheduler(shell, bad)
            rbad = (R_scheduler.SchedulerConfig(**vars(bad))
                    if isinstance(bad, P_scheduler.SchedulerConfig) else bad)
            with pytest.raises(exc) as ref_err:
                R_scheduler.Scheduler(rshell, rbad)
            assert str(port_err.value) == str(ref_err.value)
    finally:
        shell.shutdown()
        rshell.shutdown()


def test_drain_before_any_run_is_noop():
    """drain()/shutdown() on a never-started scheduler must not brick it."""
    shell = P_shell.Shell(n_regions=1, devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig())
        assert sched.drain() is None
        assert sched.shutdown() is None
        assert sched.submit(P_task.Task(kernel="K", args=_Args())) is not None
    finally:
        shell.shutdown()


def test_batch_run_reusable_after_drain():
    rng = np.random.default_rng(3)
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    tasks = [_blur(PORT, im) for im in imgs]
    shell = P_shell.Shell(n_regions=1, chunk_budget=8, devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig())
        r1 = sched.run(tasks[:1], quiet=True)
        assert sched.drain() is not None  # report fetch after a finished run
        r2 = sched.run(tasks[1:], quiet=True)  # not bricked
        assert (r1["n_done"], r2["n_done"]) == (1, 3)
        assert r2["stranded_handles"] == 0
    finally:
        shell.shutdown()
    for t, im in zip(tasks, imgs):
        _check_task(t, im)


def test_submit_run_forever_handle_end_to_end():
    """Live submission against run_forever(): result() returns the kernel
    output, a queued task cancels cleanly (at the first chunk boundary of
    the running task, with both others queued), drain() strands
    nothing."""
    rng = np.random.default_rng(0)
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    t1, t2, t3 = (_blur(PORT, im, iters=2) for im in imgs)
    shell = P_shell.Shell(n_regions=1, chunk_budget=1, devices=["cpu"])
    sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
        preemption=False))
    handles = {}
    cancelled = []

    def cancel_t3(region, task):
        if task is t1 and not cancelled:
            assert _wait_for(lambda: len(sched.policy.pending_tasks()) == 2)
            cancelled.append(handles[3].cancel())

    shell.regions[0].on_chunk = cancel_t3
    server = threading.Thread(target=sched.run_forever, daemon=True)
    server.start()
    try:
        assert sched.wait_until_serving(timeout=10.0)
        for k, t in ((1, t1), (2, t2), (3, t3)):
            handles[k] = sched.submit(t)
        out1 = handles[1].result(timeout=TIMEOUT)
        assert cancelled == [True]
        assert handles[3].status is P_task.TaskStatus.CANCELLED
        with pytest.raises(P_submit.CancelledError):
            handles[3].result(timeout=5.0)
        _check("MedianBlur", out1[0], _oracle(imgs[0], 2, "MedianBlur"))
        handles[2].result(timeout=TIMEOUT)
        rep = sched.drain(timeout=TIMEOUT)
    finally:
        sched.shutdown(timeout=10.0)
        server.join(timeout=10.0)
        shell.shutdown()
    assert rep["n_done"] == 2 and rep["cancelled"] >= 1
    assert rep["stranded_handles"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_blur(PORT, imgs[0]))


def test_batch_run_replays_through_submit_and_matches_oracle():
    rng = np.random.default_rng(1)
    tasks = []
    for i in range(4):
        img = make_image(rng, SIZE)
        tasks.append((_blur(PORT, img, kernel="GaussianBlur",
                            priority=i % 2, arrival_time=0.05 * i,
                            tenant=f"tenant{i % 2}"), img))
    shell = P_shell.Shell(n_regions=2, chunk_budget=4, devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig())
        rep = sched.run([t for t, _ in tasks], quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == 4 and rep["policy"] == "fcfs"
    assert set(rep["per_tenant"]) == {"tenant0", "tenant1"}
    assert rep["stranded_handles"] == 0
    for t, img in tasks:
        _check_task(t, img)


def test_edf_scheduler_end_to_end_reports_deadlines():
    rng = np.random.default_rng(2)
    tasks = [_blur(PORT, make_image(rng, SIZE), deadline_s=10.0 - i)
             for i in range(5)]  # reverse deadline order
    shell = P_shell.Shell(n_regions=1, chunk_budget=8, devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
            policy="edf", preemption=False))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == 5 and rep["policy"] == "edf"
    assert rep["deadline_tasks"] == 5
    served = sorted(tasks, key=lambda t: t.t_first_served)
    rest = [t.deadline_s for t in served[1:]]  # the first grab is free
    assert rest == sorted(rest)
    for t in tasks:
        _check_task(t)


# --------------------------------------------------- scheduler invariants
@pytest.mark.parametrize("seed,n_tasks,n_regions,preemption", [
    (0, 4, 1, False), (1, 6, 2, True), (2, 8, 1, True), (3, 10, 2, False),
    (4, 5, 2, True), (5, 7, 1, True)])
def test_scheduler_invariants(seed, n_tasks, n_regions, preemption):
    """No task lost; every task completes; no preemption when disabled;
    every image equals the reference's oracle whatever the schedule."""
    rng = np.random.default_rng(seed)

    def arg_factory(r, k):
        img = make_image(r, SIZE)
        return P_kernels.get_kernel(k).bundle(
            img, np.zeros_like(img), H=SIZE, W=SIZE,
            iters=int(r.integers(1, 3)))

    tasks = P_task.generate_random_tasks(
        rng, ["MedianBlur", "GaussianBlur"], n_tasks, 0.5, arg_factory)
    shell = P_shell.Shell(n_regions=n_regions, chunk_budget=3,
                          devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
            preemption=preemption))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == n_tasks, "tasks lost"
    assert all(t.status is P_task.TaskStatus.DONE for t in tasks)
    if not preemption:
        assert rep["preemptions"] == 0
    for t in tasks:
        _check_task(t)


def _service_order(side):
    rng = np.random.default_rng(0)
    tasks = [_blur(side, make_image(rng, SIZE), priority=p)
             for p in (4, 0, 2, 0, 3)]
    shell = side.Shell(n_regions=1, chunk_budget=100, devices=side.default)
    try:
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
        sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    served = sorted(tasks, key=lambda t: t.t_first_served)
    return [t.priority for t in served]


def test_priority_service_order():
    """One region, simultaneous arrivals: after the first grab, service
    follows priority order (FCFS within a priority), in both packages."""
    ref, port = (_service_order(s) for s in SIDES)
    assert port[1:] == ref[1:] == sorted(port[1:])


def _strictly_lower(side):
    """t_low runs; at its first chunk boundary an equal-priority and a
    higher-priority task arrive, and the worker waits until the scheduler
    has asked for the preemption."""
    rng = np.random.default_rng(1)
    t_low = _blur(side, make_image(rng, SIZE), iters=3, priority=3)
    t_same = _blur(side, make_image(rng, SIZE), iters=1, priority=3)
    t_high = _blur(side, make_image(rng, SIZE), iters=1, priority=0)
    shell = side.Shell(n_regions=1, chunk_budget=1, devices=side.default)
    sched = side.Scheduler(shell, side.SchedulerConfig(preemption=True))
    handles = []

    def arrive(region, task):
        if task is t_low and not handles:
            handles.extend(sched.submit(t) for t in (t_same, t_high))
            assert region._preempt.wait(TIMEOUT), "never preempted"

    side.on_chunk(shell.regions[0], arrive)
    server = threading.Thread(target=sched.run_forever, daemon=True)
    server.start()
    try:
        assert sched.wait_until_serving(timeout=10.0)
        sched.submit(t_low).result(timeout=TIMEOUT)
        for h in handles:
            h.result(timeout=TIMEOUT)
        rep = sched.drain(timeout=TIMEOUT)
    finally:
        sched.shutdown(timeout=10.0)
        server.join(timeout=10.0)
        shell.shutdown()
    assert t_high.t_first_served < t_same.t_first_served
    order = sorted((t_low, t_same, t_high), key=lambda t: t.t_done)
    return (t_low.n_preemptions, t_same.n_preemptions, rep["preemptions"],
            [t.priority for t in order],
            [tuple(np.asarray(b) for b in t.result)
             for t in (t_low, t_same, t_high)])


def test_strictly_lower_priority_preemption_matches_reference():
    """A queued task preempts only a running task of strictly lower
    priority (paper §4.3 step 2): the same preemptions and completion
    order in both packages, and the same images."""
    ref, port = (_strictly_lower(s) for s in SIDES)
    assert port[:4] == ref[:4]
    assert port[:3] == (1, 0, 1)
    assert port[3][0] == 0  # the urgent task finished first
    for a, b in zip(ref[4], port[4]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


# --------------------------------------------------------------- LRU cache
def test_lru_eviction_order():
    for side in SIDES:
        c = side.reconfig.LRUBitstreamCache(capacity=2)
        c.put(("a",), side.reconfig.CacheEntry(fn=1))
        c.put(("b",), side.reconfig.CacheEntry(fn=2))
        assert c.get(("a",)).fn == 1  # refreshes 'a': now 'b' is LRU
        c.put(("c",), side.reconfig.CacheEntry(fn=3))
        assert ("b",) not in c and ("a",) in c and ("c",) in c
        assert c.evictions == 1 and list(c.evicted_keys) == [("b",)]


def test_lru_capacity_bound():
    for side in SIDES:
        c = side.reconfig.LRUBitstreamCache(capacity=3)
        for i in range(10):
            c.put((i,), side.reconfig.CacheEntry(fn=i))
            assert len(c) <= 3
        assert c.evictions == 7
        assert c.keys() == [(7,), (8,), (9,)]  # least-recent first


def test_lru_unbounded_and_validation():
    for side in SIDES:
        c = side.reconfig.LRUBitstreamCache(capacity=None)
        for i in range(50):
            c.put((i,), side.reconfig.CacheEntry(fn=i))
        assert len(c) == 50 and c.evictions == 0
        with pytest.raises(ValueError):
            side.reconfig.LRUBitstreamCache(capacity=0)


# ------------------------------------------------- hit/miss/prefetch stats
STAT_KEYS = ("partial_loads", "cache_hits", "cold_compiles",
             "prefetch_compiles", "prefetch_hits", "prefetch_stale_drops",
             "inflight_joins", "evictions", "full_reconfigs", "cache_size",
             "cache_capacity", "prefetch_hit_rate")


def _counts(engine):
    rep = engine.report()
    counts = {k: rep[k] for k in STAT_KEYS}
    counts["per_key"] = {k: {f: v for f, v in ks.items()}
                         for k, ks in rep["per_key"].items()}
    return counts


def _bundles(side, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("MedianBlur", "GaussianBlur"):
        img = make_image(rng, SIZE)
        out[k] = side.get_kernel(k).bundle(img, np.zeros_like(img), H=SIZE,
                                           W=SIZE, iters=1)
    return out


def _engine(side, **kw):
    return (side.reconfig.ReconfigEngine(device=torch.device("cpu"), **kw)
            if side is PORT else side.reconfig.ReconfigEngine(**kw))


def _evicted_recompiles(side):
    eng = _engine(side, cache_capacity=1)
    b = _bundles(side, 0)
    eng.load("MedianBlur", b["MedianBlur"], (1,))
    eng.load("GaussianBlur", b["GaussianBlur"], (1,))   # evicts MedianBlur
    eng.load("MedianBlur", b["MedianBlur"], (1,))       # a miss again
    return _counts(eng)


def test_engine_evicted_key_recompiles():
    ref, port = (_evicted_recompiles(s) for s in SIDES)
    assert port == ref
    assert (port["evictions"], port["cold_compiles"], port["cache_hits"],
            port["cache_size"]) == (2, 3, 0, 1)


def _prefetch_stats(side):
    eng = _engine(side)
    b = _bundles(side, 1)
    steps = [eng.prefetch("MedianBlur", b["MedianBlur"], (1,))]
    eng.load("MedianBlur", b["MedianBlur"], (1,))      # a prefetch hit
    eng.load("GaussianBlur", b["GaussianBlur"], (1,))  # a cold compile
    assert eng.stats.total_stall_s > 0
    steps.append(eng.prefetch("MedianBlur", b["MedianBlur"], (1,)))
    eng.load("MedianBlur", b["MedianBlur"], (1,))      # cache reuse
    eng2 = _engine(side)
    eng2.prewarm("MedianBlur", b["MedianBlur"], (1,))
    eng2.load("MedianBlur", b["MedianBlur"], (1,))     # never a prefetch win
    key = "|".join(str(p) for p in eng.cache_key(
        "MedianBlur", b["MedianBlur"].signature(), (1,)))
    return steps, _counts(eng), _counts(eng2), key


def test_prefetch_hit_vs_cold_compile_stats():
    ref, port = (_prefetch_stats(s) for s in SIDES)
    assert port == ref
    steps, counts, prewarmed, key = port
    assert steps == ["compiled", "cached"]
    assert (counts["prefetch_compiles"], counts["prefetch_hits"],
            counts["cache_hits"], counts["cold_compiles"]) == (1, 1, 2, 1)
    assert counts["prefetch_hit_rate"] == pytest.approx(1 / 3)
    assert counts["per_key"][key]["origin"] == P_reconfig.ORIGIN_PREFETCH
    assert counts["per_key"][key]["hits"] == 2
    assert (prewarmed["prefetch_compiles"], prewarmed["prefetch_hits"]) == (
        1, 0)


def _stale_prefetch(side):
    eng = _engine(side)
    pf = side.prefetch.BitstreamPrefetcher(eng, auto_start=False)
    b = _bundles(side, 2)
    task = side.Task(kernel="MedianBlur", args=b["MedianBlur"])
    task.status = side.TaskStatus.QUEUED
    pf.submit(task, [(1,)])
    task.status = side.TaskStatus.RUNNING  # dispatched before the prefetcher
    pf.drain_once()
    first = _counts(eng)
    t2 = side.Task(kernel="GaussianBlur", args=b["GaussianBlur"])
    t2.status = side.TaskStatus.QUEUED
    pf.submit(t2, [(1,)])
    pf.drain_once()
    return first, _counts(eng), (pf.stats.submitted, pf.stats.processed)


def test_stale_prefetch_for_dequeued_task_is_dropped():
    """A hint whose task already left the queues is dropped without
    compiling; a still-queued task's hint compiles."""
    ref, port = (_stale_prefetch(s) for s in SIDES)
    assert port == ref
    first, after, (submitted, processed) = port
    assert (first["prefetch_stale_drops"], first["prefetch_compiles"],
            first["cache_size"]) == (1, 0, 0)
    assert (after["prefetch_compiles"], after["cache_size"]) == (1, 1)
    assert submitted == processed == 2


def test_prefetcher_dedupes_geometries_and_bounds_queue():
    got = []
    for side in SIDES:
        pf = side.prefetch.BitstreamPrefetcher(_engine(side), max_queue=2,
                                               auto_start=False)
        task = side.Task(kernel="MedianBlur",
                         args=_bundles(side, 3)["MedianBlur"])
        task.status = side.TaskStatus.QUEUED
        pf.submit(task, [(1,), (1,), (2,)])  # a duplicate collapses
        pf.submit(task, [(3,)])              # queue full: dropped
        got.append((pf.stats.submitted, pf.stats.dropped_full))
        pf.drain_once()
        assert pf.wait_idle(timeout=1.0)
    assert got[1] == got[0] == (2, 1)


def test_inflight_compile_dedup():
    """Two threads demanding the same missing bitstream: exactly one
    compiles, the other joins the compile in flight (a stub compile of
    fixed length keeps the two overlapping)."""
    eng = _engine(PORT)
    eng._compile = lambda kd, bundle, devices, program: (time.sleep(0.3),
                                                         lambda *a: None)[1]
    bundle = _bundles(PORT, 4)["MedianBlur"]
    errs = []

    def worker():
        try:
            eng.load("MedianBlur", bundle, (1,))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errs
    assert (eng.stats.cold_compiles, eng.stats.inflight_joins,
            eng.stats.partial_loads) == (1, 1, 2)


# ------------------------------------------------- scheduler integration
def _stream(seed, n, kernels, iters_range):
    rng = np.random.default_rng(seed)

    def arg_factory(r, k):
        img = make_image(r, SIZE)
        return P_kernels.get_kernel(k).bundle(
            img, np.zeros_like(img), H=SIZE, W=SIZE,
            iters=int(r.integers(*iters_range)))

    return P_task.generate_random_tasks(rng, kernels, n, 0.3, arg_factory)


def test_scheduler_prefetch_end_to_end():
    tasks = _stream(0, 8, ["MedianBlur", "GaussianBlur"], (1, 3))
    shell = P_shell.Shell(n_regions=2, chunk_budget=2, prefetch=True,
                          devices=["cpu"])
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig(
            preemption=True))
        rep = sched.run(tasks, quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == 8 and rep["reconfigs"] > 0
    assert 0.0 <= rep["prefetch_hit_rate"] <= 1.0
    assert rep["cold_compiles"] + rep["prefetch_compiles"] > 0
    assert rep["reconfig"]["prefetcher"]["submitted"] > 0
    assert not shell.prefetcher.alive  # shutdown stops the thread
    for t in tasks:
        _check_task(t)


def test_scheduler_prefetch_disabled_still_works():
    tasks = _stream(1, 3, ["MedianBlur"], (1, 2))
    shell = P_shell.Shell(n_regions=1, chunk_budget=2, prefetch=False,
                          devices=["cpu"])
    try:
        rep = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig()).run(
            tasks, quiet=True)
    finally:
        shell.shutdown()
    assert rep["n_done"] == 3 and rep["prefetch_hits"] == 0
    assert rep["reconfig"]["prefetcher"]["submitted"] == 0
    for t in tasks:
        _check_task(t)
