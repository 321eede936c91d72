"""The port's elastic region pool against the reference's, scenario by
scenario (the reference's ``tests/test_elastic_pool.py``).

Every scenario runs in both packages in this process on the same numpy
inputs: the reference on its grids of fake devices (``object()``s), the
port on grids of CPU devices (``devices=["cpu"] * n`` gives ``n`` distinct
``torch.device`` objects, and the floorplanner keys on identity).  Region
widths, grows, shrinks, resize kinds, task placements and every result
must agree; median images bitwise.  Drains are placed at a chunk boundary
without sleeps: the port's regions call ``on_chunk``; the reference's have
no such hook, so the test wraps their per-iteration failure check, which
the worker calls at the top of its chunk loop, right after each retired
chunk.  A drained task's commit, still held by the retired region's bank,
must agree field for field, and a commit the reference's pool made must
finish on the port's pool bit-identical to an unpreempted run of the port.
"""
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402

from repro.controller import kernels as R_kernels  # noqa: E402
from repro.core import floorplan as R_floorplan  # noqa: E402
from repro.core import pool as R_pool  # noqa: E402
from repro.core import region as R_region  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro_torch import Client  # noqa: E402
from repro_torch.controller import kernels as P_kernels  # noqa: E402
from repro_torch.core import floorplan as P_floorplan  # noqa: E402
from repro_torch.core import pool as P_pool  # noqa: E402
from repro_torch.core import region as P_region  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402
from repro_torch.core.context import ContextRecord, from_reference  # noqa: E402
from repro_torch.core.preemption import run_to_completion  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

SIZE = 128  # pads to [130, 130]: 4 row blocks a pass
TIMEOUT = 60.0
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")


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
    SchedulerConfig=R_scheduler.SchedulerConfig, pool=R_pool,
    RegionState=R_region.RegionState, Task=R_task.Task,
    TaskStatus=R_task.TaskStatus, get_kernel=R_kernels.get_kernel,
    floorplan=R_floorplan, devices=lambda n: [object() for _ in range(n)],
    default=None, on_chunk=_ref_on_chunk)
PORT = SimpleNamespace(
    name="port", Shell=P_shell.Shell, Scheduler=P_scheduler.Scheduler,
    SchedulerConfig=P_scheduler.SchedulerConfig, pool=P_pool,
    RegionState=P_region.RegionState, Task=P_task.Task,
    TaskStatus=P_task.TaskStatus, get_kernel=P_kernels.get_kernel,
    floorplan=P_floorplan, devices=lambda n: ["cpu"] * n,
    default=["cpu"], on_chunk=_port_on_chunk)
SIDES = (REF, PORT)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [make_image(rng, SIZE) for _ in range(n)]


def _task(side, img, iters=1, priority=2, footprint=None):
    kd = side.get_kernel("MedianBlur")
    return side.Task(kernel="MedianBlur",
                     args=kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                    W=SIZE, iters=iters),
                     priority=priority, footprint=footprint)


def _result(task):
    return tuple(np.asarray(b) for b in task.result)


def _assert_same_results(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def _widths(shell):
    return [len(r.devices) for r in shell.regions]


def _wait_for(cond, timeout=TIMEOUT, dt=0.01):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return cond()


def _unpreempted(img, iters):
    """The port's uninterrupted run of the same task (ping, pong)."""
    kd = P_kernels.get_kernel("MedianBlur")
    bufs, ints, floats = kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                                   W=SIZE, iters=iters).padded()
    ctx, state, _ = run_to_completion(
        kd.fn, ContextRecord.fresh(), tuple(torch.tensor(b) for b in bufs),
        ints, floats, 1)
    assert ctx.done == 1
    return tuple(s.numpy() for s in state[:2])


# ---------------------------------------------------------- floorplanning
@pytest.mark.parametrize("n_dev,n", [(7, 3), (6, 2), (5, 5), (9, 4), (1, 1)])
def test_partition_distributes_remainder(n_dev, n):
    devs = list(range(n_dev))
    want = R_floorplan.partition(devs, n)
    got = P_floorplan.partition(devs, n)
    assert got == want
    assert [d for s in got for d in s] == devs  # full coverage, in order
    if (n_dev, n) == (7, 3):
        assert [len(s) for s in got] == [3, 2, 2]


@pytest.mark.parametrize("widths", [[3, 1], [1, 1], [2, 2, 2], [5, 3],
                                    [0, 6]])
def test_partition_widths_heterogeneous_and_covering(widths):
    devs = list(range(6))
    try:
        want = R_floorplan.partition_widths(devs, widths)
    except R_floorplan.FloorplanError:
        with pytest.raises(P_floorplan.FloorplanError):
            P_floorplan.partition_widths(devs, widths)
        return
    got = P_floorplan.partition_widths(devs, widths)
    assert got == want
    assert [d for s in got for d in s] == devs
    if widths == [3, 1]:
        assert [len(s) for s in got] == [4, 2]


@pytest.mark.parametrize("footprints,n_regions,n_devices", [
    ([4, 1, 1], 2, 4), ([2, 2], 2, 6), ([], 2, 5), ([8], 3, 3),
    ([1], 3, 2)])
def test_widths_for_footprints_matches_workload(footprints, n_regions,
                                                n_devices):
    try:
        want = R_floorplan.widths_for_footprints(footprints, n_regions,
                                                 n_devices)
    except R_floorplan.FloorplanError:
        with pytest.raises(P_floorplan.FloorplanError):
            P_floorplan.widths_for_footprints(footprints, n_regions,
                                              n_devices)
        return
    assert P_floorplan.widths_for_footprints(footprints, n_regions,
                                             n_devices) == want


def test_cpu_device_grid_has_distinct_devices():
    shell = P_shell.Shell(n_regions=1, devices=["cpu"] * 3)
    try:
        assert len({id(d) for d in shell.devices}) == 3
        # the one region spans the whole grid: nothing is stranded
        assert _widths(shell) == [3] and shell.floorplanner.coverage_ok()
        assert not shell.floorplanner.overlapped
    finally:
        shell.shutdown()


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_shell_remainder_devices_not_stranded(side):
    devs = side.devices(5)
    shell = side.Shell(n_regions=2, devices=devs)
    try:
        assert sorted(_widths(shell)) == [2, 3]
        covered = {id(d) for r in shell.regions for d in r.devices}
        assert covered == {id(d) for d in shell.devices}
        assert shell.floorplanner.coverage_ok()
    finally:
        shell.shutdown()


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_shell_more_regions_than_devices_requires_overlap(side):
    with pytest.raises(ValueError, match="allow_overlap=True"):
        side.Shell(n_regions=3, devices=side.devices(2),
                   allow_overlap=False)
    shell = side.Shell(n_regions=3, devices=side.devices(2),
                       allow_overlap=True)
    try:
        assert len(shell.regions) == 3
        assert shell.floorplanner.overlapped
    finally:
        shell.shutdown()


def _repair_roundtrip(side, img):
    t = _task(side, img)
    shell = side.Shell(n_regions=1, chunk_budget=4, devices=side.default)
    try:
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
        sched.run([t], quiet=True)
        region = shell.regions[0]
        before = (region.stats.reconfigs, region.stats.kernels_run)
        assert before[1] == 1
        region.inject_failure()
        assert not region.alive and not region.dispatchable
        region.repair()
        assert region.alive and region.dispatchable
        assert region.state is side.RegionState.ACTIVE
        # stats survive the failure/repair round trip (same Region object)
        assert (region.stats.reconfigs, region.stats.kernels_run) == before
        return before, _result(t)
    finally:
        shell.shutdown()


def test_inject_failure_repair_stats_roundtrip():
    img, = _images(1, 1)
    ref, port = (_repair_roundtrip(s, img) for s in SIDES)
    assert port[0] == ref[0]
    _assert_same_results([ref[1]], [port[1]])


# ------------------------------------------------------------- autoscaler
@pytest.mark.parametrize("kwargs", [{"min_regions": 0},
                                    {"min_regions": 3, "max_regions": 2},
                                    {"grow_queue_depth": 0},
                                    {"idle_grace_s": -1.0},
                                    {"window": 0}])
def test_autoscaler_config_validation(kwargs):
    with pytest.raises(ValueError) as ref_err:
        R_pool.AutoscalerConfig(**kwargs).validate()
    with pytest.raises(ValueError) as port_err:
        P_pool.AutoscalerConfig(**kwargs).validate()
    assert str(port_err.value) == str(ref_err.value)


def _decide_both(cfg, signals):
    """Feed the same signal sequence to both autoscalers; the decisions
    must agree step for step."""
    out = []
    for side in (R_pool, P_pool):
        a = side.Autoscaler(side.AutoscalerConfig(**cfg))
        out.append([a.decide(side.PoolSignals(**s)) for s in signals])
    assert out[1] == out[0]
    return out[1]


def test_autoscaler_grow_shrink_with_hysteresis():
    cfg = dict(min_regions=1, max_regions=3, grow_queue_depth=2.0,
               cooldown_s=1.0, idle_grace_s=1.0)
    seq = [(0.0, 1, 0, 5, +1),    # queue pressure -> grow
           (0.5, 2, 0, 9, 0),     # inside the resize cooldown -> hold
           (1.2, 2, 0, 9, +1),
           (3.0, 3, 0, 99, 0),    # at the max bound
           (4.0, 3, 2, 0, 0),     # quiet: the idle grace must elapse
           (4.6, 3, 2, 0, 0),
           (5.1, 3, 2, 0, -1),
           (7.0, 2, 1, 0, 0),     # a burst resets the idle clock
           (7.5, 2, 0, 1, 0),
           (8.2, 2, 1, 0, 0)]     # grace restarted
    got = _decide_both(cfg, [dict(now=now, n_regions=n, n_idle=idle,
                                  queue_depth=q)
                             for now, n, idle, q, _ in seq])
    assert got == [want for *_, want in seq]
    # min bound: never shrinks below min_regions
    assert _decide_both(dict(min_regions=1, max_regions=3, idle_grace_s=0.0,
                             cooldown_s=0.0),
                        [dict(now=0.0, n_regions=1, n_idle=1,
                              queue_depth=0)]) == [0]


def test_autoscaler_deadline_miss_and_p99_trigger_grow():
    cfg = dict(min_regions=1, max_regions=3, grow_queue_depth=100.0,
               cooldown_s=0.0, target_p99_s=1.0)
    got = _decide_both(cfg, [
        dict(now=0.0, n_regions=1, n_idle=0, queue_depth=0, p99_s=2.0),
        dict(now=1.0, n_regions=2, n_idle=0, queue_depth=0, p99_s=0.1,
             deadline_misses=1),
        # the miss was consumed; no new misses -> no more growth
        dict(now=2.0, n_regions=3, n_idle=0, queue_depth=0, p99_s=0.1,
             deadline_misses=1)])
    assert got == [+1, +1, 0]


# ------------------------------------------------- placement feasibility
def _placement(side, imgs):
    shell = side.Shell(n_regions=2, devices=side.devices(3),
                       region_widths=[2, 1], chunk_budget=4)
    try:
        widths = _widths(shell)
        wide = _task(side, imgs[0], footprint=2)
        narrow = _task(side, imgs[1], footprint=1)
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
        rep = sched.run([wide, narrow], quiet=True)
        return (widths, rep["n_done"], wide.region_history,
                [_result(wide), _result(narrow)])
    finally:
        shell.shutdown()


def test_footprint_placement_lands_on_wide_region():
    imgs = _images(2, 2)
    ref, port = (_placement(s, imgs) for s in SIDES)
    assert port[:3] == ref[:3] == ([2, 1], 2, [0])  # only region 0 is wide
    _assert_same_results(ref[3], port[3])


def _infeasible(side, imgs):
    shell = side.Shell(n_regions=1, devices=side.devices(2), chunk_budget=4)
    try:
        t = _task(side, imgs[0], footprint=5)  # wider than the whole grid
        ok = _task(side, imgs[1])
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
        rep = sched.run([t, ok], quiet=True)
        assert t.status is side.TaskStatus.FAILED and t in sched.failed
        assert ok.status is side.TaskStatus.DONE
        return rep["n_done"], _result(ok)
    finally:
        shell.shutdown()


def test_infeasible_footprint_fails_at_admission():
    imgs = _images(3, 2)
    ref, port = (_infeasible(s, imgs) for s in SIDES)
    assert port[0] == ref[0] == 1
    _assert_same_results([ref[1]], [port[1]])


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_static_shell_rejects_wider_than_widest_region(side):
    # fits the grid (8 devices) but not any region of the STATIC 4+4
    # floorplan, which can never be re-cut: must fail at admission
    # instead of sitting in the queue forever and hanging drain()
    img, = _images(4, 1)
    shell = side.Shell(n_regions=2, devices=side.devices(8), chunk_budget=4)
    try:
        t = _task(side, img, footprint=5)
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False))
        rep = sched.run([t], quiet=True)
        assert t.status is side.TaskStatus.FAILED and rep["n_done"] == 0
    finally:
        shell.shutdown()


def _consolidate(side, imgs, min_regions, footprints):
    shell = side.Shell(n_regions=2, devices=side.devices(4), chunk_budget=4,
                       allow_overlap=False)
    try:
        tasks = [_task(side, im, footprint=f)
                 for im, f in zip(imgs, footprints)]
        pool = side.pool.RegionPool(shell, min_regions=min_regions,
                                    max_regions=2)
        sched = side.Scheduler(shell, side.SchedulerConfig(preemption=False),
                               pool=pool)
        rep = sched.run(tasks, quiet=True)
        assert shell.floorplanner.coverage_ok()
        return (rep["n_done"], [t.status.value for t in tasks],
                max(_widths(shell)), len(shell.regions), pool.grows,
                pool.shrinks,
                [_result(t) for t in tasks
                 if t.status is side.TaskStatus.DONE])
    finally:
        shell.shutdown()


def test_pool_consolidates_slices_for_wide_footprint():
    # 2+2 floorplan, task needs 3: the pool re-cuts the idle slices
    # (footprint-matched replan) so the task can be placed
    imgs = _images(5, 1)
    ref, port = (_consolidate(s, imgs, 1, [3]) for s in SIDES)
    assert port[:6] == ref[:6]
    assert port[0] == 1 and port[2] >= 3
    _assert_same_results(ref[6], port[6])


def test_rescue_respects_min_regions_and_admission_ceiling():
    # min_regions=2 on 4 devices: the widest achievable region is 3; a
    # footprint of 3 is served without the pool dropping below two
    # regions, a footprint of 4 is rejected at admission
    imgs = _images(6, 2)
    ref, port = (_consolidate(s, imgs, 2, [3, 4]) for s in SIDES)
    assert port[:6] == ref[:6]
    assert port[1] == ["done", "failed"] and port[3] >= 2
    _assert_same_results(ref[6], port[6])


# ------------------------------------------------------ pool mechanics
def _replan_after_retire(side):
    shell = side.Shell(n_regions=3, devices=side.devices(6),
                       allow_overlap=False)
    pool = side.pool.RegionPool(shell, min_regions=1, max_regions=3)
    try:
        before = _widths(shell)
        victim = shell.regions[2]
        pool.begin_retire(victim)          # idle -> no preemption needed
        assert victim.state is side.RegionState.DRAINING
        retired = pool.finalize_retirements()
        assert victim.state is side.RegionState.RETIRED
        assert shell.floorplanner.coverage_ok()
        # geometry changed -> loaded bitstream invalidated
        assert all(r.loaded is None for r in shell.regions)
        return (before, retired, _widths(shell),
                [r.geometry for r in shell.regions], pool.shrinks,
                pool.grows)
    finally:
        shell.shutdown()


def test_replan_widens_idle_regions_after_retirement():
    ref, port = (_replan_after_retire(s) for s in SIDES)
    assert port == ref
    assert port[:3] == ([2, 2, 2], [2], [3, 3])


def _carve(side, allow_overlap):
    shell = side.Shell(n_regions=2, devices=side.devices(4),
                       allow_overlap=allow_overlap)
    pool = side.pool.RegionPool(shell, min_regions=1, max_regions=3)
    try:
        region = pool.grow()
        assert region is not None
        assert shell.floorplanner.coverage_ok()
        widths = _widths(shell)
        overlapped = shell.floorplanner.overlapped
        again = pool.grow()                # the max bound holds
        return (widths, overlapped, again is None, len(shell.regions),
                [e[1:] for e in pool.resize_events])
    finally:
        shell.shutdown()


@pytest.mark.parametrize("allow_overlap", [False, True])
def test_grow_carves_slice_from_idle_regions(allow_overlap):
    # carving is preferred over time-sharing even when overlap is allowed:
    # an overlapped grid is one-way and disables floorplanning
    ref, port = (_carve(s, allow_overlap) for s in SIDES)
    assert port == ref
    assert sorted(port[0]) == [1, 1, 2] and not port[1]
    assert port[2] and port[3] == 3


def test_grow_time_shares_the_single_device_grid():
    """The one-card layout: ``[device]`` with overlap allowed.  A grow
    adds a region on the same device (on a card, a new stream), the grid
    turns overlapped, and replans change nothing."""
    got = []
    for side in SIDES:
        shell = side.Shell(n_regions=1, devices=side.devices(1))
        pool = side.pool.RegionPool(shell, min_regions=1, max_regions=2)
        try:
            region = pool.grow()
            assert region is not None
            assert region.devices[0] is shell.regions[0].devices[0]
            got.append((_widths(shell), shell.floorplanner.overlapped,
                        pool.replan([1, 1]), pool.grows))
        finally:
            shell.shutdown()
    assert got[1] == got[0] == ([1, 1], True, {}, 1)


@pytest.mark.parametrize("window,want", [((0.0, 10.0), 13.0),
                                         ((4.0, 6.0), 3.0),
                                         ((6.0, 7.0), 1.0)])
def test_region_seconds_window_accounting(window, want):
    for side in SIDES:
        shell = side.Shell(n_regions=1, devices=side.devices(1))
        pool = side.pool.RegionPool(shell, min_regions=1, max_regions=2)
        try:
            pool._spans = {0: [0.0, 5.0], 1: [2.0, None]}
            assert pool.region_seconds(*window) == pytest.approx(want)
        finally:
            shell.shutdown()


def _drain_cycle(side, img, iters):
    """Grow to two regions, start a long task, drain-retire the region
    running it at its first chunk boundary: the task is
    checkpoint-preempted, requeued and finishes on the survivor."""
    t_long = _task(side, img, iters=iters)
    shell = side.Shell(n_regions=1, chunk_budget=1, devices=side.default)
    pool = side.pool.RegionPool(shell, min_regions=1, max_regions=2)
    sched = side.Scheduler(shell, side.SchedulerConfig(preemption=True),
                           pool=pool)
    server = threading.Thread(target=sched.run_forever, daemon=True)
    server.start()
    fired = []

    def hook(region, task):
        if task is t_long and not fired:
            fired.append(region.rid)
            pool.request_shrink(region.rid)  # drain the region running it
            assert region._preempt.wait(TIMEOUT), "the drain never landed"

    try:
        assert sched.wait_until_serving(timeout=10.0)
        pool.request_grow()
        assert _wait_for(lambda: len(shell.regions) == 2)
        for r in shell.regions:
            side.on_chunk(r, hook)
        out = sched.submit(t_long).result(timeout=TIMEOUT)
        assert _wait_for(lambda: len(shell.regions) == 1)
        retired = shell.region(fired[0])
        assert retired.state is side.RegionState.RETIRED
        commit = retired.bank.restore().materialize()
        rep = sched.drain(timeout=TIMEOUT)
        assert rep["stranded_handles"] == 0
        return {"fired": fired, "history": t_long.region_history,
                "n_preemptions": t_long.n_preemptions,
                "grows": pool.grows, "shrinks": pool.shrinks,
                "kinds": [e["kind"] for e in rep["pool"]["resize_events"]],
                "pool_keys": sorted(rep["pool"]),
                "elastic": rep["pool"]["elastic"],
                "resizes": rep["pool"]["resizes"],
                "context": {f: np.asarray(getattr(commit.context, f))
                            for f in FIELDS},
                "payload": tuple(np.asarray(b) for b in commit.payload),
                "commit": commit,
                "out": tuple(np.asarray(b) for b in out)}
    finally:
        sched.shutdown(timeout=10.0)
        server.join(timeout=10.0)
        shell.shutdown()


def test_grow_drain_shrink_cycle_resumes_preempted_task():
    """The full elastic cycle in both packages at the same chunk boundary:
    the same placements, resize kinds, commit (every ``ContextRecord``
    field and the payload) and result; the port's result equals its own
    unpreempted run, and the reference's oracle."""
    iters = 4
    img, = _images(7, 1)
    ref, port = (_drain_cycle(s, img, iters) for s in SIDES)
    for key in ("fired", "history", "n_preemptions", "grows", "shrinks",
                "kinds", "pool_keys", "elastic", "resizes"):
        assert port[key] == ref[key], key
    assert port["n_preemptions"] == 1 and len(set(port["history"])) == 2
    assert port["kinds"] == ["grow", "shrink"] and port["resizes"] == 2
    for f in FIELDS:
        np.testing.assert_array_equal(port["context"][f], ref["context"][f],
                                      err_msg=f"commit field {f}")
    _assert_same_results([ref["payload"], ref["out"]],
                         [port["payload"], port["out"]])
    for got, want in zip(port["out"], _unpreempted(img, iters)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port["out"][iters % 2], np.asarray(iterated_blur_ref(img, iters,
                                                             "median")))


def test_reference_drained_task_finishes_on_the_port_pool():
    """State carried across: the commit the reference's pool drain made
    (held by its retired region's bank) crosses with ``from_reference``,
    resumes on the port's pool, is drained once more there at its first
    chunk boundary, and finishes bit-identical to an unpreempted run of
    the port."""
    iters = 4
    img, = _images(8, 1)
    ref = _drain_cycle(REF, img, iters)
    committed = from_reference(ref["commit"])
    assert committed.context.done == 0

    task = _task(PORT, img, iters=iters)
    task.saved_context = committed
    shell = P_shell.Shell(n_regions=2, chunk_budget=1, devices=["cpu"])
    pool = P_pool.RegionPool(shell, min_regions=1, max_regions=2)
    client = Client(backend=P_scheduler.Scheduler(shell, pool=pool))
    fired = []

    def hook(region, t):
        if not fired:
            fired.append(region.rid)
            pool.request_shrink(region.rid)
            assert region._preempt.wait(TIMEOUT), "the drain never landed"

    try:
        for r in shell.regions:
            r.on_chunk = hook
        out = client.submit(task).result(timeout=TIMEOUT)
        rep = client.report()
    finally:
        client.shutdown()
        shell.shutdown()
    assert task.n_preemptions == 1 and len(set(task.region_history)) == 2
    assert rep["pool"]["shrinks"] == 1
    for got, want in zip(out, _unpreempted(img, iters)):
        np.testing.assert_array_equal(got, want)
    _assert_same_results([ref["out"]], [tuple(np.asarray(b) for b in out)])


def _autoscale(side, imgs):
    tasks = [_task(side, im, iters=2) for im in imgs]
    shell = side.Shell(n_regions=1, chunk_budget=1, devices=side.default)
    shell.region_slowdown_s = 0.02
    for r in shell.regions:
        r.slowdown_s = 0.02
    pool = side.pool.RegionPool(shell, autoscaler=side.pool.Autoscaler(
        side.pool.AutoscalerConfig(min_regions=1, max_regions=2,
                                   grow_queue_depth=1.0, cooldown_s=0.05,
                                   idle_grace_s=0.05)))
    sched = side.Scheduler(shell, side.SchedulerConfig(), pool=pool)
    server = threading.Thread(target=sched.run_forever, daemon=True)
    server.start()
    try:
        assert sched.wait_until_serving(timeout=10.0)
        for h in [sched.submit(t) for t in tasks]:
            h.result(timeout=TIMEOUT)
        assert pool.grows >= 1, "burst never grew the pool"
        # quiet line: the idle-grace shrink fires within a few loop ticks
        assert _wait_for(lambda: pool.shrinks >= 1, timeout=10.0)
        rep = sched.drain(timeout=TIMEOUT)
        assert rep["n_done"] == len(tasks)
        assert rep["stranded_handles"] == 0
        assert rep["pool"]["elastic"] and rep["pool"]["region_seconds"] > 0
        assert 0.0 <= rep["pool"]["utilization"]
        return sorted(rep["pool"]), [_result(t) for t in tasks]
    finally:
        sched.shutdown(timeout=10.0)
        server.join(timeout=10.0)
        shell.shutdown()


def test_autoscaler_grows_under_burst_and_shrinks_when_quiet():
    imgs = _images(9, 6)
    ref, port = (_autoscale(s, imgs) for s in SIDES)
    assert port[0] == ref[0]
    _assert_same_results(ref[1], port[1])


def test_client_adopts_a_pool_backed_scheduler():
    """``Client(backend=Scheduler(..., pool=...))``: the Client starts and
    owns the loop, not the shell; ``launch`` and the report go through
    the pool-backed scheduler."""
    img, = _images(10, 1)
    shell = P_shell.Shell(n_regions=1, devices=["cpu"])
    pool = P_pool.RegionPool(shell, min_regions=1, max_regions=2)
    client = Client(backend=P_scheduler.Scheduler(shell, pool=pool))
    try:
        h = client.launch("MedianBlur", (img.copy(), np.zeros_like(img)),
                          H=SIZE, W=SIZE, iters=1)
        np.testing.assert_array_equal(
            h.result(timeout=TIMEOUT)[1],
            np.asarray(iterated_blur_ref(img, 1, "median")))
        rep = client.drain(TIMEOUT)
        assert rep["pool"]["elastic"] and rep["n_done"] == 1
        assert all(r.alive for r in shell.regions)  # the shell is not ours
    finally:
        client.shutdown()
        shell.shutdown()
