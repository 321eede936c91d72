"""The port's cluster fabric (``repro_torch.cluster``) against the
reference's ``repro.cluster``: the twins of ``tests/test_cluster.py``, run
on ``devices=["cpu"]`` shells, and the new cases of the seventh slice.

- **Routers** run side by side with the reference's on the same fake
  nodes and must choose the same shell.
- **Migrations and failures are placed at chunk boundaries**, never by
  sleeps or ``slowdown_s``: an ``on_chunk`` hook (``_Hold``) holds the
  task's worker at its k-th boundary until the driving thread has asked
  for the preemption (``fe.migrate``) or killed the node
  (``inject_failure``).  ``migrate`` itself blocks until the handoff
  fires, which needs that worker, so it is never called from the hook.
- **Results** are held bitwise against an uninterrupted one-shell run of
  the port, and (median) against the reference's oracle.  A commit
  migrated through the spill is held field for field against the
  reference's, migrated at the same boundary by the reference's frontend.
- **Telemetry**: ``TelemetryMonitor.attach(cluster=)`` gauges equal the
  reference's under a frozen clock.

Every test must leave no thread behind (``no_thread_leaks``).
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402

from repro import obs as R_obs  # noqa: E402
from repro.cluster import frontend as R_frontend  # noqa: E402
from repro.cluster import node as R_node  # noqa: E402
from repro.cluster import router as R_router  # noqa: E402
from repro.controller import kernels as R_kernels  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.cluster import (ClusterError, ClusterFrontend,  # noqa: E402
                                 ClusterNode, NodePowerModel,
                                 make_router_policy)
from repro_torch.cluster import frontend as P_frontend  # noqa: E402
from repro_torch.cluster import node as P_node  # noqa: E402
from repro_torch.cluster import router as P_router  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from repro_torch.core.shell import Shell  # noqa: E402
from repro_torch.core.task import Task  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

SIZE = 128       # pads to [130, 130]: 4 row blocks a pass
BUDGET = 2       # 2 chunks a pass
CPU = ["cpu"]
TIMEOUT = 60.0
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")


@pytest.fixture(autouse=True)
def no_thread_leaks():
    """Frontend/node teardown must not leave any background thread behind
    (monitor, node loops, region workers, prefetchers)."""
    before = set(threading.enumerate())
    yield
    deadline = time.perf_counter() + 8.0
    extra = []
    while time.perf_counter() < deadline:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"threads leaked by the test: {extra}"


def _wait_for(cond, timeout=TIMEOUT, dt=0.002):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return cond()


def _blur_task(rng, iters=1, priority=2, img=None, kernel="MedianBlur"):
    if img is None:
        img = make_image(rng, SIZE)
    kd = get_kernel(kernel)
    return Task(kernel=kernel,
                args=kd.bundle(img, np.zeros_like(img), H=SIZE, W=SIZE,
                               iters=iters),
                priority=priority)


def _make_frontend(n_shells=2, **kw):
    return ClusterFrontend(n_shells=n_shells, regions_per_shell=1,
                           chunk_budget=BUDGET, devices=CPU, **kw)


def _regions(fe, nodes=None):
    return [r for n in (nodes if nodes is not None else fe.nodes)
            for r in n.shell.regions]


def _uninterrupted(img, iters):
    """Uninterrupted single-shell run of the same payload in the port (the
    bit-for-bit reference for migration and failover), itself held
    against the reference's oracle."""
    shell = Shell(n_regions=1, chunk_budget=BUDGET, devices=CPU)
    try:
        t = _blur_task(None, iters=iters, img=img)
        rep = Scheduler(shell, SchedulerConfig(preemption=False)).run([t])
        assert rep["n_done"] == 1
    finally:
        shell.shutdown()
    out = np.asarray(t.result[0])
    oracle = np.asarray(iterated_blur_ref(jnp.asarray(img), iters, "median"))
    np.testing.assert_array_equal(t.result[iters % 2], oracle)
    return out


class _Hold:
    """``on_chunk`` hook: at the ``k``-th retired chunk of task ``tid``
    (counted on every region it is installed on, once) set ``reached`` and
    hold the worker there until ``release(region)`` — the migrator's
    preempt request, or the injected failure — so the driving thread
    places a migration or a failure at exactly that boundary."""

    def __init__(self, tid, k, release):
        self.tid, self.k, self.release = tid, k, release
        self.seen = 0
        self.reached = threading.Event()
        self.region = None
        self.held = None

    def __call__(self, region, task):
        if task.tid != self.tid or self.reached.is_set():
            return
        self.seen += 1
        if self.seen < self.k:
            return
        self.region = region
        self.reached.set()
        self.held = _wait_for(lambda: self.release(region))

    def install(self, regions):
        for r in regions:
            r.on_chunk = self
        return self

    def wait(self):
        assert self.reached.wait(TIMEOUT), "the task never reached its hold"


def _preempted(region):
    return region._preempt.is_set()


def _failed(region):
    return region._failed.is_set()


# -------------------------------------------------------------- routers
class _FakeNode:
    def __init__(self, node_id, load=0.0, warm=False, power=None,
                 n_regions=1):
        self.node_id = node_id
        self._load = load
        self._warm = warm
        self.power = power
        self._n = n_regions

    def load(self):
        return self._load

    def has_bitstream(self, task):
        return self._warm

    def n_dispatchable(self):
        return self._n


ROUTER_SIDES = ((R_router, R_node), (P_router, P_node))


def _choose(router_name, specs, **kw):
    """The node id each package's router picks from the same fakes."""
    picks = []
    for router, node in ROUTER_SIDES:
        nodes = [_FakeNode(i, load=ld, warm=w,
                           power=node.NodePowerModel(*(p or ())))
                 for i, (ld, w, p) in enumerate(specs)]
        policy = getattr(router, router_name)(**kw)
        picks.append(policy.choose(None, nodes).node_id)
    assert picks[0] == picks[1], picks
    return picks[1]


def test_make_router_policy_registry():
    assert P_router.ROUTER_NAMES == R_router.ROUTER_NAMES
    for name in P_router.ROUTER_NAMES:
        assert make_router_policy(name).name == name
        assert (make_router_policy(name).name
                == R_router.make_router_policy(name).name)
    with pytest.raises(ValueError, match="unknown router policy"):
        make_router_policy("round-robin")
    with pytest.raises(ValueError):
        P_router.BitstreamAffinity(max_load_gap=0)


def test_least_loaded_router_ties_break_low_id():
    assert _choose("LeastLoaded", [(2.0, False, None), (0.5, False, None),
                                   (0.5, False, None)]) == 1


def test_affinity_router_prefers_warm_cache_with_hotspot_guard():
    # warm shell wins despite moderate extra load...
    assert _choose("BitstreamAffinity", [(2.0, True, None),
                                         (0.0, False, None)],
                   max_load_gap=3.0) == 0
    # ...but not when it is a hot spot (gap above the guard)
    assert _choose("BitstreamAffinity", [(5.0, True, None),
                                         (0.0, False, None)],
                   max_load_gap=3.0) == 1
    # no warm shell anywhere: falls back to least-loaded
    assert _choose("BitstreamAffinity", [(2.0, False, None),
                                         (1.0, False, None)],
                   max_load_gap=3.0) == 1


def test_power_aware_router_prefers_efficient_shell():
    hungry, frugal = (60.0, 40.0), (10.0, 8.0)
    assert _choose("PowerAware", [(0.0, False, hungry),
                                  (0.0, False, frugal)]) == 1
    # heavy backlog on the frugal shell eventually tips the scale
    assert _choose("PowerAware", [(0.0, False, hungry),
                                  (20.0, False, frugal)]) == 0


# ------------------------------------------------- submit/route/cancel
def test_cluster_spreads_load_and_reports(rng):
    fe = _make_frontend()
    try:
        tasks = [_blur_task(rng, iters=2) for _ in range(4)]
        handles = [fe.submit(t) for t in tasks]
        for h, t in zip(handles, tasks):
            out = h.result(timeout=TIMEOUT)
            np.testing.assert_array_equal(
                out[0], _uninterrupted(t.args.bufs[0], 2))
        rep = fe.report()
        assert rep["n_done"] == 4 and rep["lost_tasks"] == 0
        assert rep["n_shells"] == 2 and rep["router"] == "least-loaded"
        assert set(rep["per_shell"]) == {0, 1}
        assert sum(s["n_done"] for s in rep["per_shell"].values()) == 4
        # the least-loaded router spread the burst over both shells
        assert all(s["n_done"] >= 1 for s in rep["per_shell"].values())
        assert rep["turnaround_p99_s"] >= rep["turnaround_p50_s"] > 0
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_cluster_cancel_while_queued(rng):
    fe = _make_frontend()
    go = threading.Event()
    blockers = [_blur_task(rng, iters=6) for _ in range(2)]
    ids = {t.tid for t in blockers}

    def hold(region, task):
        if task.tid in ids:
            go.wait(TIMEOUT)

    for r in _regions(fe):
        r.on_chunk = hold
    try:
        handles = [fe.submit(t) for t in blockers]
        victim = fe.submit(_blur_task(rng, priority=4))
        assert victim.cancel()
        assert victim.cancelled() and victim.done()
        go.set()
        for h in handles:
            h.result(timeout=TIMEOUT)
    finally:
        go.set()
        rep = fe.shutdown()
        assert rep["cancelled"] == 1 and rep["stranded_handles"] == 0


def test_submit_after_shutdown_rejected(rng):
    fe = _make_frontend()
    fe.shutdown()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(_blur_task(rng))
    # idempotent: a second shutdown is a no-op returning the same report
    assert fe.shutdown() is fe.last_report


def test_shell_shutdown_idempotent(rng):
    shell = Shell(n_regions=2, devices=CPU)
    shell.shutdown()
    assert not any(r.alive for r in shell.regions)
    shell.shutdown()  # second call must be a clean no-op


# ------------------------------------------------------------ migration
@pytest.mark.parametrize("iters,seed,boundary,engine", [
    (4, 0, 1, "pipelined"), (9, 17, 5, "pipelined"), (3, 5, 2, "sync"),
    (6, 9, 11, "sync")])
def test_migration_equivalence_property(iters, seed, boundary, engine):
    """A task checkpoint-preempted on shell A at chunk ``boundary`` and
    resumed on shell B produces output bit-identical to an uninterrupted
    single-shell run (checkpoint resume is deterministic replay)."""
    rng = np.random.default_rng(seed)
    img = make_image(rng, SIZE)
    ref = _uninterrupted(img, iters)
    fe = _make_frontend(engine=engine)
    try:
        t = _blur_task(rng, iters=iters, img=img)
        hold = _Hold(t.tid, boundary, _preempted).install(_regions(fe))
        h = fe.submit(t)
        hold.wait()
        assert fe.migrate(tid=t.tid, prefer="running", timeout=20.0)
        out = np.asarray(h.result(timeout=TIMEOUT)[0])
        assert hold.held
        assert h.n_migrations == 1
        assert len(set(h.node_history)) == 2
        assert h.task.n_preemptions == 1
        np.testing.assert_array_equal(out, ref)
        rep = fe.shutdown()
        assert rep["lost_tasks"] == 0 and rep["stranded_handles"] == 0
    finally:
        fe.shutdown()


def test_forced_running_migration_carries_checkpoint(rng):
    """Long task migrated mid-run: it must resume (not restart) on the
    target — its context made the checksummed disk round trip."""
    img = make_image(rng, SIZE)
    ref = _uninterrupted(img, 12)
    fe = _make_frontend()
    try:
        t = _blur_task(rng, iters=12, img=img)
        hold = _Hold(t.tid, 4, _preempted).install(_regions(fe))
        h = fe.submit(t)
        hold.wait()
        assert fe.migrate(tid=t.tid, prefer="running", timeout=20.0)
        out = np.asarray(h.result(timeout=TIMEOUT)[0])
        np.testing.assert_array_equal(out, ref)
        assert h.task.saved_context is None  # consumed by the resume
        assert h.task.run_s > 0
        rep = fe.report()
        assert rep["migrations_completed"] == 1
        # the migrated-out task vanished from shell A's books and
        # completed on shell B; nothing stranded anywhere
        src, dst = h.node_history
        assert rep["per_shell"][src]["migrated_out"] == 1
        assert rep["per_shell"][dst]["migrated_out"] == 0
        # resumed, not restarted: shell B ran only the chunks left
        chunks = {n.node_id: sum(r.stats.chunks for r in n.shell.regions)
                  for n in fe.nodes}
        assert chunks[src] == 4 or chunks[src] == 5   # + the one in flight
        assert chunks[src] + chunks[dst] == 12 * 4 // BUDGET
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_migrate_queued_task_and_drain_node(rng):
    """drain_node moves every outstanding task off a shell (queued tasks
    cancel-resubmit; running tasks checkpoint-preempt) and stops routing
    to it."""
    fe = _make_frontend()
    tasks = [_blur_task(rng, iters=4) for _ in range(6)]
    # every task shell 0 starts waits at its first chunk boundary for the
    # drain's preempt request, so none can finish before it is moved
    held, first = set(), threading.Event()

    def hold(region, task):
        if task.tid not in held:
            held.add(task.tid)
            first.set()
            _wait_for(lambda: _preempted(region))

    for r in _regions(fe, fe.nodes[:1]):
        r.on_chunk = hold
    try:
        handles = [fe.submit(t) for t in tasks]
        assert first.wait(TIMEOUT)
        moved = fe.drain_node(0, timeout=20.0)
        assert moved == 3    # tasks 0, 2 and 4 were routed to shell 0
        # whatever was outstanding on shell 0 moved to shell 1
        for h in handles:
            h.result(timeout=TIMEOUT)
        rep = fe.report()
        assert rep["migrations_completed"] == moved
        assert all(h.node_history[-1] == 1 for h in handles
                   if h.n_migrations)
        assert rep["lost_tasks"] == 0
        # the drained shell takes no new work
        assert fe.submit(_blur_task(rng)).node_history == [1]
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_migration_with_single_shell_degrades_to_noop(rng):
    fe = _make_frontend(n_shells=1)
    try:
        h = fe.submit(_blur_task(rng, iters=6))
        # nowhere to go: the task must neither fail nor cancel
        assert fe.migrate(prefer="any") is False
        assert h.result(timeout=TIMEOUT) is not None
    finally:
        rep = fe.shutdown()
        assert rep["lost_tasks"] == 0 and rep["stranded_handles"] == 0


def test_migrated_commit_equals_the_references_field_for_field(tmp_path):
    """Both frontends migrate the same task at the same chunk boundary
    (sync engines): the commit read back from each spill is the same, field
    for field and payload byte for byte, and so are the final images."""
    rng = np.random.default_rng(21)
    img = make_image(rng, SIZE)
    iters, boundary = 3, 3
    spills = {}
    for side in ("ref", "port"):
        spill = str(tmp_path / side)
        if side == "ref":
            fe = R_frontend.ClusterFrontend(
                n_shells=2, regions_per_shell=1, chunk_budget=BUDGET,
                engine="sync", prefetch=False, spill_dir=spill)
            kd = R_kernels.get_kernel("MedianBlur")
            t = R_task.Task(kernel="MedianBlur", args=kd.bundle(
                img.copy(), np.zeros_like(img), H=SIZE, W=SIZE, iters=iters))
            hold = _Hold(t.tid, boundary, _preempted)
            for r in _regions(fe):   # the reference's regions have no
                check = r._check_failure   # on_chunk: wrap the check the
                seen = [0]                 # worker makes after each chunk

                def wrapped(r=r, check=check, seen=seen):
                    check()
                    if (r.current_task is not None
                            and r.stats.chunks > seen[0]):
                        seen[0] = r.stats.chunks
                        hold(r, r.current_task)

                r._check_failure = wrapped
        else:
            fe = _make_frontend(engine="sync", prefetch=False,
                                spill_dir=spill)
            t = _blur_task(None, iters=iters, img=img.copy())
            hold = _Hold(t.tid, boundary, _preempted).install(_regions(fe))
        try:
            h = fe.submit(t)
            hold.wait()
            assert fe.migrate(tid=t.tid, prefer="running", timeout=20.0)
            out = tuple(np.asarray(b) for b in h.result(timeout=TIMEOUT))
            (name,) = [f for f in os.listdir(spill) if f.endswith(".npz")]
            with np.load(os.path.join(spill, name)) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            spills[side] = (name.split(".", 1)[1], leaves, out,
                            h.node_history)
        finally:
            fe.shutdown()
    (rname, rleaves, rout, rhist), (pname, pleaves, pout, phist) = (
        spills["ref"], spills["port"])
    assert rname == pname and rhist == phist == [0, 1]
    # the context record's fields, then the payload's buffers
    assert len(rleaves) == len(pleaves) > len(FIELDS)
    for i, (a, b) in enumerate(zip(rleaves, pleaves)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf_{i}")
    for a, b in zip(rout, pout):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- failover
def test_node_failure_readmits_everything(rng):
    img = make_image(rng, SIZE)
    ref = _uninterrupted(img, 6)
    fe = _make_frontend()
    try:
        tasks = [_blur_task(rng, iters=6, img=img) for _ in range(4)]
        # the first task (shell 0) is held at its 2nd chunk until shell 0
        # dies, with shell 1 already serving
        hold = _Hold(tasks[0].tid, 2, _failed).install(_regions(fe))
        handles = [fe.submit(t) for t in tasks]
        hold.wait()
        fe.nodes[0].inject_failure()
        outs = [np.asarray(h.result(timeout=TIMEOUT)[0]) for h in handles]
        for out in outs:
            np.testing.assert_array_equal(out, ref)
        rep = fe.report()
        assert rep["failovers"] == 1
        ev = rep["failover_events"][0]
        on_dead = sum(h.node_history[0] == 0 for h in handles)
        assert ev["node"] == 0 and ev["readmitted"] == on_dead >= 1
        assert rep["lost_tasks"] == 0
        assert not fe.nodes[0].healthy and fe.nodes[1].healthy
        assert rep["per_shell"][0]["crash"]  # recorded, not a traceback
        assert rep["dead_shells"] == [0]
        # dead shell takes no new work; the survivor does
        h = fe.submit(_blur_task(rng, img=img, iters=1))
        assert h.node_history == [1]
        h.result(timeout=TIMEOUT)
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_failover_resumes_from_migration_checkpoint(rng):
    """Migrate A->B (leaves a verified spill checkpoint), then kill B:
    the failover re-admission on A resumes from that checkpoint and the
    final output still matches the uninterrupted reference."""
    img = make_image(rng, SIZE)
    ref = _uninterrupted(img, 14)
    fe = _make_frontend()
    try:
        t = _blur_task(rng, iters=14, img=img)
        migrate = _Hold(t.tid, 4, _preempted).install(
            _regions(fe, fe.nodes[:1]))
        kill = _Hold(t.tid, 3, _failed).install(_regions(fe, fe.nodes[1:]))
        h = fe.submit(t)
        migrate.wait()
        assert fe.migrate(tid=t.tid, prefer="running", timeout=20.0)
        assert h.node_history == [0, 1]
        # let it run a few chunks on the target, then kill the target
        kill.wait()
        fe.nodes[1].inject_failure()
        out = np.asarray(h.result(timeout=TIMEOUT)[0])
        np.testing.assert_array_equal(out, ref)
        rep = fe.report()
        assert rep["failovers"] == 1
        assert rep["failover_events"][0]["resumed_from_checkpoint"] >= 1
        assert h.n_failovers == 1 and rep["lost_tasks"] == 0
        assert h.node_history == [0, 1, 0]
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_failover_materializes_a_dead_regions_device_commit(rng):
    """A task checkpoint-preempted on shell 0 (its commit left in the lazy
    spill, owned by shell 0's region) is failed over when shell 0 dies: the
    survivor materializes that commit to the host and uploads its own copy
    (no device-resident resume across shells), bit-identically."""
    img, img2 = make_image(rng, SIZE), make_image(rng, SIZE)
    ref = _uninterrupted(img, 6)
    fe = _make_frontend()
    try:
        fe._no_route.add(1)   # both tasks go to shell 0
        bg = _blur_task(rng, iters=6, img=img, priority=4)
        urgent = _blur_task(rng, iters=6, img=img2, priority=0)
        until_preempted = _Hold(bg.tid, 3, _preempted).install(
            _regions(fe))
        h_bg = fe.submit(bg)
        until_preempted.wait()
        kill = _Hold(urgent.tid, 1, _failed).install(_regions(fe))
        h_urgent = fe.submit(urgent)   # preempts bg on shell 0
        kill.wait()
        fe._no_route.discard(1)
        committed = bg.saved_context
        assert committed is not None and committed.device
        assert committed.owner is fe.nodes[0].shell.regions[0]
        fe.nodes[0].inject_failure()
        np.testing.assert_array_equal(
            np.asarray(h_bg.result(timeout=TIMEOUT)[0]), ref)
        np.testing.assert_array_equal(
            np.asarray(h_urgent.result(timeout=TIMEOUT)[0]),
            _uninterrupted(img2, 6))
        survivor = fe.nodes[1].shell.regions[0]
        assert survivor.stats.host_spills_avoided == 0
        assert h_bg.node_history == [0, 1] and h_bg.n_failovers == 1
        rep = fe.report()
        assert rep["failover_events"][0]["resumed_from_checkpoint"] >= 1
        assert rep["lost_tasks"] == 0
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_all_shells_dead_fails_loudly_not_silently(rng):
    fe = _make_frontend()
    try:
        t = _blur_task(rng, iters=4)
        hold = _Hold(t.tid, 1, _failed).install(_regions(fe))
        h = fe.submit(t)
        hold.wait()
        for node in fe.nodes:
            node.inject_failure()
        assert h.wait(timeout=TIMEOUT)
        with pytest.raises(RuntimeError):
            h.result(timeout=1.0)
        with pytest.raises(ClusterError):
            fe.submit(_blur_task(rng))
    finally:
        fe.shutdown()


def test_node_death_during_migration_does_not_orphan_task(rng):
    """The batch failover skips records owned by an in-flight migrator;
    once the migrator lets go, the monitor must still re-admit them —
    the handle may never hang until shutdown."""
    fe = _make_frontend()
    try:
        t = _blur_task(rng, iters=6)
        hold = _Hold(t.tid, 1, _failed).install(_regions(fe))
        h = fe.submit(t)
        rec = fe._records[t.tid]
        with fe._lock:
            rec.migrating = True   # simulate a migrator holding the task
        hold.wait()
        fe.nodes[rec.node.node_id].inject_failure()
        # wait until the batch failover ran and skipped the record
        assert _wait_for(lambda: fe.failover_events)
        assert fe.failover_events[0]["readmitted"] == 0
        assert not h.done()
        with fe._lock:
            rec.migrating = False  # migrator gives up (its source died)
        assert h.result(timeout=TIMEOUT) is not None  # re-admitted
        rep = fe.report()
        assert rep["lost_tasks"] == 0 and h.n_failovers == 1
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_migrate_to_too_narrow_target_refused(rng):
    """An explicit migration target narrower than the task's footprint
    must be refused up front — not detach the task and let the target's
    admission destroy it."""
    wide = ClusterNode(0, shell=Shell(n_regions=1, devices=["cpu", "cpu"],
                                      chunk_budget=BUDGET))
    narrow = ClusterNode(1, shell=Shell(n_regions=1, devices=CPU,
                                        chunk_budget=BUDGET))
    fe = ClusterFrontend(nodes=[wide, narrow])
    try:
        t = _blur_task(rng, iters=4)
        t.footprint = 2
        h = fe.submit(t)
        assert h.node_history == [0]   # only the wide shell fits it
        assert fe.migrate(tid=t.tid, target=1, timeout=5.0) is False
        assert h.result(timeout=TIMEOUT) is not None
        rep = fe.report()
        assert rep["lost_tasks"] == 0 and rep["migrations_completed"] == 0
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


# ------------------------------------------------------------ rebalance
def test_rebalancer_moves_work_off_hot_shell(rng):
    """Stack every task on shell 0 (drain shell 1 from routing first,
    then re-open it): the monitor's rebalancer must migrate some of the
    backlog to the idle shell.  The first task holds shell 0's worker at
    its first chunk until the rebalancer has moved something."""
    fe = _make_frontend(rebalance=True, rebalance_threshold=2.0,
                        rebalance_cooldown_s=0.05)
    tasks = [_blur_task(rng, iters=4) for _ in range(8)]
    hold = _Hold(tasks[0].tid, 1,
                 lambda r: fe.migrations_completed >= 1).install(
                     _regions(fe))
    try:
        fe._no_route.add(1)  # route the whole burst to shell 0
        handles = [fe.submit(t) for t in tasks]
        fe._no_route.discard(1)  # shell 1 is back; imbalance is huge
        for h in handles:
            h.result(timeout=TIMEOUT)
        assert hold.held
        rep = fe.report()
        assert rep["migrations_completed"] >= 1
        assert any(h.n_migrations for h in handles)
        assert rep["lost_tasks"] == 0
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


# --------------------------------------------------------- power model
def test_power_aware_cluster_routes_to_frugal_shell(rng):
    nodes = [
        ClusterNode(0, n_regions=1, chunk_budget=BUDGET, devices=CPU,
                    power=NodePowerModel(idle_w=60.0, active_w=40.0)),
        ClusterNode(1, n_regions=1, chunk_budget=BUDGET, devices=CPU,
                    power=NodePowerModel(idle_w=10.0, active_w=8.0)),
    ]
    fe = ClusterFrontend(nodes=nodes, router="power-aware")
    try:
        h = fe.submit(_blur_task(rng))
        assert h.node_history == [1]  # the frugal shell wins at equal load
        h.result(timeout=TIMEOUT)
        rep = fe.report()
        assert rep["energy_j_total"] > 0
    finally:
        rep = fe.shutdown()
        assert rep["stranded_handles"] == 0


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterFrontend(n_shells=2, start=False)


# ------------------------------------------------------------ telemetry
def test_monitor_cluster_gauges_equal_the_references(monkeypatch):
    """``TelemetryMonitor.attach(cluster=fe)`` on a frontend of each
    package, the same busy seconds and power models, one frozen clock:
    the ``node_*`` gauges (and everything else the tick polls) read the
    same, in Prometheus text and in the snapshot."""
    monkeypatch.setattr(time, "perf_counter", lambda: 9000.0)
    powers = ((25.0, 15.0), (10.0, 8.0))
    texts, snaps = [], []
    for obs, fe_mod, node_mod, kw in (
            (R_obs, R_frontend, R_node, {}),
            (P_obs, P_frontend, P_node, {"devices": CPU})):
        fe = fe_mod.ClusterFrontend(
            n_shells=2, regions_per_shell=2, start=False, prefetch=False,
            power_models=[node_mod.NodePowerModel(*p) for p in powers],
            **kw)
        try:
            for i, node in enumerate(fe.nodes):
                for j, r in enumerate(node.shell.regions):
                    r.stats.busy_s = 0.25 * (i + 1) + 0.5 * j
            reg = obs.MetricsRegistry()
            mon = obs.TelemetryMonitor(reg).attach(cluster=fe, site="a")
            for now in (9000.0, 9003.5):
                mon.sample(now=now)
            texts.append(obs.prometheus_text(reg))
            snap = reg.snapshot()
            snaps.append({k: v for k, v in snap.items()
                          if k != "uptime_s"})
        finally:
            fe.shutdown()
    assert texts[0] == texts[1]
    assert snaps[0] == snaps[1]
    assert "repro_node_energy_joules" in texts[1]
    assert 'repro_node_healthy{node="1",site="a"} 0' in texts[1]
