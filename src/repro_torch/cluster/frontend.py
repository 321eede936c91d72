"""Cluster frontend: N shells behind one ``submit() -> handle`` API.

The port of ``repro/cluster/frontend.py``, behaviour unchanged; "DESIGN.md"
section references point at the reference's note at the repository root.
On the one H100 every shell's regions are CUDA streams on ``cuda:0``
(``devices=`` in ``shell_kwargs`` reaches every node's ``Shell``; the CPU
tests pass ``["cpu"]``).  A migration hop between two shells of one card
still goes device -> host -> disk -> host -> device, as the reference
defines it (``_spill_roundtrip``): the source's commit is materialized on
the host, written through the checksummed store, read back verified, and
uploaded by the destination region.  A failover resumes from the dead
shell's bank, whose commit may still be device-resident: the destination
region materializes it (after its ``ready`` event) and uploads its own
copy, so no tensor of a dead region reaches a live region's stream.

The fabric federates the paper's single-shell preemptive server into a
fleet (DESIGN.md §7).  Three mechanisms, all built from machinery the
shells already have:

- **Routing** — every submitted task goes through a pluggable
  ``RouterPolicy`` (``router.py``) over the healthy shells; the FPGA
  analogue is the data-center job manager placing a kernel on one of many
  boards (arXiv 2311.11015).

- **Cross-shell migration** — a running task is checkpoint-preempted
  through the ordinary chunked-preemption path (the paper's §5
  ``checkpoint``/``for_save`` machinery), its committed context bank +
  partial outputs are serialized through ``ckpt/store.py`` (checksummed;
  a corrupt spill aborts the migration instead of resuming wrong), and an
  equivalent task resumes on another shell.  Checkpoint resume is
  deterministic replay, so a migrated task's final output is bit-identical
  to an uninterrupted single-shell run — the invariant the migration
  tests and the cluster benchmark assert.  This is exactly the
  checkpoint-based task migration of arXiv 2301.07615, lifted from
  CPU<->FPGA to shell<->shell.

- **Failover** — a heartbeat monitor polls each node (scheduler loop
  live + >=1 region alive, i.e. the existing ``REGION_FAILED`` machinery
  observed at node granularity).  When a shell dies, its outstanding
  tasks are re-admitted on surviving shells from their last checkpoint
  (the task's own saved context, the region bank's tid-matched commit, or
  the last migration spill), oldest-first; nothing is stranded — every
  cluster handle resolves.

Thread model: client threads call ``submit``/``cancel``/``migrate``; one
``cluster-monitor`` thread resolves handles, detects death, and (when
``rebalance=True``) migrates work off overloaded shells.  Each node's
scheduler loop and region workers run exactly as they do single-shell.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.ckpt.store import (CheckpointCorruptError, load_pytree,
                                    save_pytree)
from repro_torch.cluster.node import ClusterNode, NodePowerModel
from repro_torch.cluster.router import RouterPolicy, make_router_policy
from repro_torch.core.context import Committed
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.submit import (CancelledError, MigratedError,
                                     TaskFailedError, TaskHandle)
from repro_torch.core.task import Task, TaskStatus


class ClusterError(RuntimeError):
    """No healthy shell can take the task (routing/failover dead end)."""


class ClusterTaskHandle:
    """Future for one cluster-submitted task.  Unlike a node-local
    ``TaskHandle`` it survives migration and failover: the frontend
    re-targets the underlying node handle; this one only resolves when
    the task is terminally done, failed, or cancelled."""

    def __init__(self, record: "_Record"):
        self._record = record
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancelled = False
        self._result = None
        self._exception: Optional[BaseException] = None

    # -- client side -----------------------------------------------------
    @property
    def task(self) -> Task:
        return self._record.task   # the current incarnation

    @property
    def tid(self) -> int:
        return self._record.tid

    @property
    def status(self) -> TaskStatus:
        return self._record.task.status

    @property
    def n_migrations(self) -> int:
        """Completed cross-shell migrations of this task."""
        return self._record.n_migrations

    @property
    def n_failovers(self) -> int:
        return self._record.n_failovers

    @property
    def node_history(self) -> List[int]:
        """Shell ids this task was admitted on, in order."""
        return list(self._record.node_history)

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"cluster task #{self.tid} not done within {timeout}s "
                f"(status={self.status.value})")
        if self._cancelled:
            raise CancelledError(f"task #{self.tid} was cancelled")
        if self._exception is not None:
            raise TaskFailedError(
                f"task #{self.tid} failed") from self._exception
        return self._result

    def cancel(self) -> bool:
        return self._record.frontend._cancel(self._record)

    # -- frontend side ---------------------------------------------------
    def _resolve(self, result):
        with self._lock:
            if self._done.is_set():
                return
            self._result = result
            self._done.set()

    def _fail(self, exc: BaseException):
        with self._lock:
            if self._done.is_set():
                return
            self._exception = exc
            self._done.set()

    def _resolve_cancelled(self):
        with self._lock:
            if self._done.is_set():
                return
            self._cancelled = True
            self._done.set()


@dataclass
class _Record:
    """Frontend-side state for one cluster task."""
    tid: int
    task: Task                       # current incarnation (clone chain)
    frontend: "ClusterFrontend"
    node: ClusterNode
    inner: TaskHandle
    t_submit: float
    handle: ClusterTaskHandle = None
    migrating: bool = False
    cancel_requested: bool = False
    finished: bool = False           # outstanding-- happened
    t_done: Optional[float] = None
    n_migrations: int = 0            # cross-shell hops (frontend-initiated)
    n_failovers: int = 0
    # last checkpoint this task was resumed from (failover fallback when
    # the dead shell's bank has nothing fresher for it)
    last_ckpt: Optional[Committed] = None
    node_history: List[int] = field(default_factory=list)


def _clone_for_resume(task: Task, committed: Optional[Committed],
                      src_sched, dst_sched) -> Task:
    """A fresh ``Task`` that resumes ``task`` on another shell.  A *copy*
    is mandatory: the source scheduler's queues may still reference the
    old object (lazily dropped as cancelled), so mutating it back to
    QUEUED could double-dispatch."""
    deadline = task.deadline_s
    if deadline is not None and src_sched is not None:
        # deadline_s is relative to each serving loop's start; translate
        # through the absolute clock so urgency survives the hop
        deadline = max(0.0, src_sched.t0 + deadline - dst_sched.t0)
    # phase survives the hop (phase-affinity routing of the resume);
    # region_pin deliberately does NOT — pins are shell-local rids.
    clone = Task(kernel=task.kernel, args=task.args, priority=task.priority,
                 arrival_time=0.0, deadline_s=deadline, tenant=task.tenant,
                 footprint=task.footprint, phase=task.phase,
                 sequence=task.sequence, tid=task.tid)
    clone.saved_context = committed
    # per-task budget override survives the hop (a stale default budget on
    # the destination shell would change chunk boundaries mid-task)
    clone.chunk_budget = task.chunk_budget
    clone.t_arrived = task.t_arrived          # end-to-end turnaround
    clone.t_first_served = task.t_first_served
    clone.n_preemptions = task.n_preemptions
    clone.n_reconfigs = task.n_reconfigs
    clone.n_migrations = task.n_migrations + 1
    clone.run_s = task.run_s
    clone.region_history = list(task.region_history)
    return clone


class ClusterFrontend:
    """N ``ClusterNode`` shells behind one submit API (DESIGN.md §7).

    ``router`` is a registry name (``router.ROUTER_NAMES``) or a
    ``RouterPolicy`` instance.  ``rebalance=True`` lets the monitor thread
    migrate queued work off a shell whose load runs ``rebalance_threshold``
    tasks-per-region ahead of the lightest shell.  ``spill_dir`` is where
    migration checkpoints land (a temp dir by default, removed at
    shutdown).
    """

    def __init__(self, n_shells: int = 2, *, regions_per_shell: int = 1,
                 router: Union[str, RouterPolicy] = "least-loaded",
                 nodes: Optional[Sequence[ClusterNode]] = None,
                 config: Optional[SchedulerConfig] = None,
                 power_models: Optional[Sequence[NodePowerModel]] = None,
                 rebalance: bool = False,
                 rebalance_threshold: float = 2.0,
                 rebalance_cooldown_s: float = 0.25,
                 migrate_timeout_s: float = 15.0,
                 poll_s: float = 0.01,
                 spill_dir: Optional[str] = None,
                 start: bool = True,
                 tracer=None,
                 metrics=None,
                 **shell_kwargs):
        # flight recorder (obs/, DESIGN.md §11): ONE shared handle for the
        # whole fabric — every node shell emits into the same timeline as
        # the frontend's route/migrate/failover events, so a cross-shell
        # migration reads as one contiguous story in the trace.  The live
        # metrics registry (obs/registry.py, §12) threads identically.
        self.tracer = tracer
        self.metrics = metrics
        self._trace_track = ("cluster", 0)
        if nodes is not None:
            self.nodes: List[ClusterNode] = list(nodes)
            if tracer is None:  # adopt a tracer the caller's shells carry
                self.tracer = next(
                    (t for t in (getattr(n.shell, "tracer", None)
                                 for n in self.nodes) if t is not None),
                    None)
            if metrics is None:  # adopt a registry the shells carry
                self.metrics = next(
                    (m for m in (getattr(n.shell, "metrics", None)
                                 for n in self.nodes) if m is not None),
                    None)
        else:
            if n_shells < 1:
                raise ValueError(f"n_shells must be >= 1, got {n_shells}")
            self.nodes = [
                ClusterNode(
                    i, n_regions=regions_per_shell,
                    config=replace(config) if config is not None else None,
                    power=(power_models[i] if power_models else None),
                    tracer=tracer,
                    metrics=metrics,
                    **shell_kwargs)
                for i in range(n_shells)]
        self.router: RouterPolicy = (
            router if isinstance(router, RouterPolicy)
            else make_router_policy(router))
        self.rebalance = rebalance
        self.rebalance_threshold = rebalance_threshold
        self.rebalance_cooldown_s = rebalance_cooldown_s
        self.migrate_timeout_s = migrate_timeout_s
        self.poll_s = poll_s
        self._own_spill = spill_dir is None
        self.spill_dir = (spill_dir if spill_dir is not None
                          else tempfile.mkdtemp(prefix="repro-cluster-"))
        os.makedirs(self.spill_dir, exist_ok=True)

        self._lock = threading.RLock()
        self._records: Dict[int, _Record] = {}
        self._dead_nodes: set = set()
        self._no_route: set = set()     # draining: alive but not routable
        self._closed = False
        self._shutdown_done = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._last_rebalance = 0.0
        self._t0 = time.perf_counter()
        self.last_report: Optional[dict] = None

        # counters (under _lock)
        self.migrations_attempted = 0
        self.migrations_completed = 0
        self.failover_events: List[dict] = []
        self._n_done = 0
        self._n_failed = 0
        self._n_cancelled = 0
        self._stranded = 0

        if start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ClusterFrontend":
        for n in self.nodes:
            n.start()
        if self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="cluster-monitor",
                daemon=True)
            self._monitor.start()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def drain(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Refuse new submissions, wait for everything outstanding to
        resolve (migrations and failovers still run), then tear down and
        return the final cluster report."""
        with self._lock:
            self._closed = True
        deadline = None if timeout is None else time.perf_counter() + timeout
        for rec in list(self._records.values()):
            left = (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))
            if not rec.handle.wait(left):
                raise TimeoutError(
                    f"cluster did not drain within {timeout}s "
                    f"(task #{rec.tid} still {rec.task.status.value})")
        return self.shutdown()

    def shutdown(self, timeout: float = 15.0) -> Optional[dict]:
        """Idempotent teardown: stop routing, stop the monitor, shut every
        node down (queued tasks cancel, running tasks finish), settle all
        cluster handles (unresolved ones fail loudly and count as
        stranded), and return the final report.  No background thread —
        monitor, node loops, region workers, prefetchers — survives."""
        with self._lock:
            self._closed = True
            if self._shutdown_done:
                return self.last_report
            self._shutdown_done = True
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
            self._monitor = None
        for n in self.nodes:
            n.shutdown(timeout=timeout)
        self._poll_once()      # propagate the shutdown cancellations
        with self._lock:
            for rec in self._records.values():
                if not rec.handle.done():
                    self._stranded += 1
                    rec.handle._fail(RuntimeError(
                        f"task #{rec.tid} stranded at cluster shutdown "
                        f"(status={rec.task.status.value})"))
                    self._finish(rec)
        self.last_report = self.report()
        if self._own_spill:
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        return self.last_report

    # -- submission ------------------------------------------------------
    def submit(self, task: Task) -> ClusterTaskHandle:
        """Route ``task`` to a healthy shell and return a cluster handle
        that survives cross-shell migration and node failover."""
        with self._lock:
            if self._closed:
                raise RuntimeError("cluster frontend is closed")
            node = self._route(task)
            if self.tracer is not None:
                self.tracer.emit("route", self._trace_track, tid=task.tid,
                                 node=node.node_id)
            if self.metrics is not None:
                self.metrics.counter("cluster_routes_total",
                                     node=node.node_id).inc()
            rec = _Record(tid=task.tid, task=task, frontend=self,
                          node=node, inner=None,
                          t_submit=time.perf_counter())
            rec.handle = ClusterTaskHandle(rec)
            rec.node_history.append(node.node_id)
            try:
                rec.inner = node.submit(task)
            except RuntimeError as e:       # node died inside the window
                rec.handle._fail(e)
                rec.finished = True
                self._records[task.tid] = rec
                self._n_failed += 1
                return rec.handle
            node.outstanding += 1
            self._records[task.tid] = rec
            return rec.handle

    def _route(self, task: Task,
               exclude: Optional[set] = None) -> ClusterNode:
        """Healthy, placement-feasible candidates -> router policy.
        Raises ``ClusterError`` when no shell qualifies."""
        need = task.footprint or 1
        skip = (exclude or set()) | self._dead_nodes | self._no_route
        cands = [n for n in self.nodes
                 if n.healthy and n.node_id not in skip
                 and need <= max(1, n.max_width())]
        if not cands:
            raise ClusterError(
                f"no healthy shell can place task #{task.tid} "
                f"(footprint {need}, {len(self.nodes)} shells, "
                f"{len(self._dead_nodes)} dead)")
        return self.router.choose(task, cands)

    def _cancel(self, rec: _Record) -> bool:
        with self._lock:
            if rec.handle.done():
                return False
            if rec.migrating:
                # the migrator owns the task right now; it honours the
                # flag instead of resubmitting
                rec.cancel_requested = True
                return True
            ok = rec.inner.cancel()
            if ok:
                rec.handle._resolve_cancelled()
                self._n_cancelled += 1
                self._finish(rec)
            return ok

    # -- migration -------------------------------------------------------
    def migrate(self, tid: Optional[int] = None,
                source: Optional[int] = None,
                target: Optional[int] = None,
                prefer: str = "any",
                timeout: Optional[float] = None) -> bool:
        """Move one task to another shell; True on a completed migration.

        With no arguments: pick the most loaded healthy shell and move its
        most recently submitted migratable task to the shell the router
        likes best.  ``prefer="running"`` only considers tasks currently
        executing (forces the checkpoint-preempt path); ``"queued"`` only
        tasks still waiting (cancel-and-resubmit, no context to carry);
        ``"any"`` prefers queued — the cheap move — then running.
        Gracefully returns False when the task finishes first, the source
        is already drained, or no target shell qualifies."""
        with self._lock:
            rec, src = self._pick_migration(tid, source, prefer)
            if rec is None:
                return False
            tgt = self.nodes[target] if target is not None else None
            if tgt is not None and (
                    tgt is src or not tgt.healthy
                    or (rec.task.footprint or 1) > max(1, tgt.max_width())):
                return False   # never detach for an infeasible target
            if tgt is None:
                try:    # never detach a task with nowhere to go
                    self._route(rec.task, exclude={src.node_id})
                except ClusterError:
                    return False
            rec.migrating = True
            self.migrations_attempted += 1
        try:
            return self._do_migrate(
                rec, src,
                self.nodes[target] if target is not None else None,
                timeout=self.migrate_timeout_s if timeout is None
                else timeout)
        finally:
            with self._lock:
                rec.migrating = False

    def drain_node(self, node_id: int,
                   timeout: Optional[float] = None) -> int:
        """Migrate every outstanding task off ``node_id`` (running tasks
        checkpoint-preempt) and stop routing to it.  Returns how many
        tasks moved; the node keeps serving whatever could not move."""
        node = self.nodes[node_id]
        with self._lock:
            self._no_route.add(node_id)     # no new routing to it; it can
        moved = 0                           # still die and fail over later
        for rec in list(self._records.values()):
            if rec.node is node and not rec.handle.done():
                if self.migrate(tid=rec.tid, timeout=timeout):
                    moved += 1
        return moved

    def _pick_migration(self, tid, source, prefer):
        """(record, source node) under ``_lock``; (None, None) if nothing
        qualifies."""
        if tid is not None:
            rec = self._records.get(tid)
            if (rec is None or rec.handle.done() or rec.migrating
                    or rec.cancel_requested):
                return None, None
            return rec, rec.node
        if source is not None:
            src = self.nodes[source]
        else:
            busy = [n for n in self.nodes if n.healthy and n.outstanding]
            if not busy:
                return None, None
            src = max(busy, key=lambda n: (n.load(), -n.node_id))
        want = {"running": (TaskStatus.RUNNING, TaskStatus.RECONFIGURING),
                "queued": (TaskStatus.QUEUED, TaskStatus.PENDING,
                           TaskStatus.PREEMPTED),
                "any": None}[prefer]
        cands = [r for r in self._records.values()
                 if r.node is src and not r.handle.done()
                 and not r.migrating and not r.cancel_requested
                 and (want is None or r.task.status in want)]
        if not cands:
            return None, None
        if prefer == "any":   # cheap moves first: queued over running
            queued = [r for r in cands
                      if r.task.status not in (TaskStatus.RUNNING,
                                               TaskStatus.RECONFIGURING)]
            cands = queued or cands
        return max(cands, key=lambda r: r.t_submit), src

    def _do_migrate(self, rec: _Record, src: ClusterNode,
                    target: Optional[ClusterNode], timeout: float) -> bool:
        task = rec.task
        t_mig0 = time.perf_counter()
        if not self._take_task(rec, src, timeout):
            return False
        # we own the task: its source handle is settled, its context (if
        # it ever ran) is committed in task.saved_context
        try:
            committed = self._spill_roundtrip(task, kind="migration")
        except CheckpointCorruptError:
            committed = None   # restart from scratch rather than trust it
        ok = self._resubmit(rec, src, committed, target=target,
                            kind="migration")
        if self.tracer is not None:
            self.tracer.emit_span("migrate", self._trace_track, t_mig0,
                                  tid=task.tid, src=src.node_id, ok=ok)
        return ok

    def _take_task(self, rec: _Record, src: ClusterNode,
                   timeout: float) -> bool:
        """Detach ``rec.task`` from its source shell: cancel it while
        queued, or checkpoint-preempt it through the scheduler's handoff
        hook while running.  False when the task completed first (or the
        node died — the monitor's failover takes over)."""
        task, inner = rec.task, rec.inner
        if inner.cancel():
            return True
        box: dict = {}
        handed = threading.Event()

        def handoff(t):
            box["task"] = t
            handed.set()

        sched = src.scheduler
        sched.request_handoff(task.tid, handoff)
        deadline = time.perf_counter() + timeout
        try:
            while not handed.wait(0.004):
                if inner.cancel():              # drifted back to a queue
                    sched.cancel_handoff(task.tid)
                    return True
                if inner.done() and not inner.migrated():
                    sched.cancel_handoff(task.tid)
                    return False                # finished/failed first
                if not src.healthy:
                    sched.cancel_handoff(task.tid)
                    return False                # failover path owns it now
                if time.perf_counter() > deadline:
                    if sched.cancel_handoff(task.tid):
                        return False            # withdrew in time
                    handed.wait(1.0)            # fired concurrently
                    break
                if task.status is TaskStatus.RUNNING:
                    for r in src.shell.regions:
                        if r.current_task is task:
                            r.request_preempt()
                            break
        finally:
            sched.cancel_handoff(task.tid)
        return handed.is_set()

    def _spill_roundtrip(self, task: Task, kind: str) -> Optional[Committed]:
        """Serialize the task's committed context + partial outputs through
        the checkpoint store and read it back verified — the migrated
        resume consumes only bytes that survived the checksummed disk
        round trip (what a real fabric ships between hosts).

        Preemption commits are device-resident (lazy spill, DESIGN.md §8.2);
        this is the point where the committed host copy is actually
        produced — ``materialize()`` pays the device→host transfer exactly
        once, here, instead of on every preemption."""
        committed = task.saved_context
        if committed is None:
            return None
        committed = committed.materialize()
        like = {"context": committed.context, "payload": committed.payload}
        path = os.path.join(
            self.spill_dir,
            f"task{task.tid}.hop{task.n_migrations}.{kind}.npz")
        save_pytree(path, like, meta={
            "tid": task.tid, "seqno": committed.seqno, "kind": kind})
        loaded = load_pytree(path, like)
        return Committed(committed.seqno, loaded["context"],
                         loaded["payload"], tid=committed.tid)

    def _resubmit(self, rec: _Record, src: ClusterNode,
                  committed: Optional[Committed],
                  target: Optional[ClusterNode], kind: str) -> bool:
        """Second half of migration/failover: clone the task for resume and
        admit it on the target shell, updating the record atomically.  A
        migration whose target vanished mid-flight degrades to a local
        requeue on the source (False — nothing happened); a task only
        fails when *no* shell, source included, can re-admit it."""
        task = rec.task
        with self._lock:
            if rec.cancel_requested:
                rec.handle._resolve_cancelled()
                self._n_cancelled += 1
                self._finish(rec)
                return False
            candidates = []
            if (target is not None and target.healthy
                    and (task.footprint or 1) <= max(1, target.max_width())):
                candidates.append(target)
            else:
                try:
                    candidates.append(
                        self._route(task, exclude={src.node_id}))
                except ClusterError:
                    pass
            if (src.healthy and src.node_id not in self._dead_nodes
                    and src not in candidates):
                candidates.append(src)   # last resort: give it back
            placed = None
            for tgt in candidates:
                clone = _clone_for_resume(task, committed,
                                          src_sched=src.scheduler,
                                          dst_sched=tgt.scheduler)
                try:
                    new_inner = tgt.submit(clone)
                except RuntimeError:
                    continue             # died inside the window
                placed = tgt
                break
            if placed is None:
                rec.handle._fail(ClusterError(
                    f"no healthy shell can re-admit task #{task.tid} "
                    f"({kind})"))
                self._n_failed += 1
                self._finish(rec)
                return False
            self._finish(rec)            # src.outstanding--
            rec.task = clone
            rec.inner = new_inner
            rec.node = placed
            rec.finished = False
            rec.last_ckpt = committed
            rec.node_history.append(placed.node_id)
            placed.outstanding += 1
            if placed is src:
                return False             # degraded to a local requeue
            if kind == "migration":
                rec.n_migrations += 1
                self.migrations_completed += 1
            else:
                rec.n_failovers += 1
            if self.metrics is not None:
                self.metrics.counter("cluster_%ss_total" % kind).inc()
            return True

    # -- monitor: handle resolution, heartbeats, failover, rebalance -----
    def _monitor_loop(self):
        while not self._stop.is_set():
            try:
                self._check_health()
                self._poll_once()
                if self.rebalance:
                    self._maybe_rebalance()
            except Exception:  # pragma: no cover — a monitor crash must
                import traceback    # not silently freeze every handle

                traceback.print_exc()
            self._stop.wait(self.poll_s)

    def _poll_once(self):
        with self._lock:
            live = [r for r in self._records.values()
                    if not r.handle.done() and not r.migrating
                    and r.inner is not None]
        for rec in live:
            inner = rec.inner
            if not inner.done() or inner.migrated():
                continue
            try:
                result = inner.result(timeout=0)
            except CancelledError:
                with self._lock:
                    if rec.migrating:       # migrator got it meanwhile
                        continue
                    rec.handle._resolve_cancelled()
                    self._n_cancelled += 1
                    self._finish(rec)
            except MigratedError:           # settled by a handoff that the
                continue                    # migrator is still completing
            except (TaskFailedError, TimeoutError):
                if rec.node.healthy:
                    with self._lock:
                        rec.handle._fail(RuntimeError(
                            f"task #{rec.tid} failed on shell "
                            f"{rec.node.node_id}"))
                        self._n_failed += 1
                        self._finish(rec)
                else:
                    dead = rec.node
                    self._node_dead(dead)
                    # a record that was mid-migration when the batch
                    # failover ran was skipped (the migrator owned it);
                    # once the migrator has let go, re-admit it here or
                    # its handle would hang until shutdown
                    with self._lock:
                        orphaned = (not rec.migrating
                                    and not rec.handle.done()
                                    and rec.node is dead)
                    if orphaned:
                        self._resubmit(
                            rec, dead, self._recover_committed(rec, dead),
                            target=None, kind="failover")
            else:
                with self._lock:
                    rec.t_done = time.perf_counter()
                    rec.handle._resolve(result)
                    self._n_done += 1
                    self._finish(rec)

    def _finish(self, rec: _Record):
        """Caller holds ``_lock``: settle the record's capacity share."""
        if not rec.finished:
            rec.finished = True
            rec.node.outstanding = max(0, rec.node.outstanding - 1)

    def _check_health(self):
        for node in self.nodes:
            if (node.started and not node.healthy
                    and node.node_id not in self._dead_nodes
                    and not self._stop.is_set()):
                self._node_dead(node)

    def _node_dead(self, node: ClusterNode):
        """Failover: mark the shell dead and re-admit its outstanding
        tasks on survivors, each from its best available checkpoint."""
        with self._lock:
            if node.node_id in self._dead_nodes:
                return
            self._dead_nodes.add(node.node_id)
            victims = [r for r in self._records.values()
                       if r.node is node and not r.handle.done()
                       and not r.migrating]
            victims.sort(key=lambda r: r.t_submit)   # oldest first
        readmitted = resumed = 0
        for rec in victims:
            committed = self._recover_committed(rec, node)
            if self._resubmit(rec, node, committed, target=None,
                              kind="failover"):
                readmitted += 1
                resumed += committed is not None
        with self._lock:
            self.failover_events.append({
                "node": node.node_id,
                "t_s": time.perf_counter() - self._t0,
                "readmitted": readmitted,
                "resumed_from_checkpoint": resumed,
            })
        if self.tracer is not None:
            self.tracer.emit("failover", self._trace_track,
                             node=node.node_id, readmitted=readmitted,
                             resumed=resumed)
        if self.metrics is not None:
            self.metrics.counter("cluster_failover_events_total",
                                 node=node.node_id).inc()

    def _recover_committed(self, rec: _Record,
                           node: ClusterNode) -> Optional[Committed]:
        """Best checkpoint a dead shell left for this task: the task's own
        saved context (freshest — it was preempted and waiting), else the
        context bank of a region it ran on (commits are tid-tagged so a
        stale commit from another task never resumes into this one), else
        the last migration spill.  ``None`` restarts from scratch —
        checkpoint resume is replay, so any older valid checkpoint still
        yields the identical final output."""
        task = rec.task
        if task.saved_context is not None:
            if task.saved_context.tid in (None, task.tid):
                return task.saved_context
        for rid in reversed(task.region_history):
            region = node.shell._by_rid.get(rid)
            if region is None:
                continue
            committed = region.bank.restore()
            if committed is not None and committed.tid == task.tid:
                return committed
        return rec.last_ckpt

    def _maybe_rebalance(self):
        now = time.perf_counter()
        if now - self._last_rebalance < self.rebalance_cooldown_s:
            return
        with self._lock:
            healthy = [n for n in self.nodes if n.healthy]
            if len(healthy) < 2:
                return
            hi = max(healthy, key=lambda n: (n.load(), -n.node_id))
            lo = min(healthy, key=lambda n: (n.load(), n.node_id))
            if hi.load() - lo.load() < self.rebalance_threshold:
                return
            src_id, dst_id = hi.node_id, lo.node_id
        self._last_rebalance = now
        self.migrate(source=src_id, target=dst_id, prefer="any",
                     timeout=self.migrate_timeout_s)

    # -- observability ---------------------------------------------------
    def report(self) -> dict:
        """Aggregated cluster report: end-to-end latency across shells
        (frontend clocks: submit -> resolve), per-shell scheduler reports,
        migration/failover accounting."""
        with self._lock:
            recs = list(self._records.values())
            counters = dict(
                n_done=self._n_done, n_failed=self._n_failed,
                cancelled=self._n_cancelled,
                stranded_handles=self._stranded,
                migrations_attempted=self.migrations_attempted,
                migrations_completed=self.migrations_completed,
                failover_events=list(self.failover_events))
        turnarounds = sorted(rec.t_done - rec.t_submit for rec in recs
                             if rec.t_done is not None)
        t_end = max((rec.t_done for rec in recs
                     if rec.t_done is not None), default=self._t0)
        raw_wall = t_end - self._t0
        wall = max(raw_wall, 1e-9)
        per_shell = {}
        for node in self.nodes:
            sched = node.scheduler
            rep = (sched.last_report if sched.last_report is not None
                   and not sched.serving else sched.report())
            per_shell[node.node_id] = {
                k: rep.get(k) for k in (
                    "n_done", "policy", "throughput_tps",
                    "turnaround_p50_s", "turnaround_p99_s",
                    "preemptions", "migrations", "migrated_out",
                    "cancelled", "stranded_handles", "reconfigs",
                    "cache_hits", "prefetch_hit_rate",
                    "dispatch_stall_s")}
            per_shell[node.node_id].update({
                "healthy": node.healthy,
                "crash": str(node.crash) if node.crash else None,
                "n_regions": len(node.shell.regions),
                "outstanding": node.outstanding,
                "utilization": rep["pool"]["utilization"],
                "region_seconds": rep["pool"]["region_seconds"],
                # idle draw over the shell's wall window + active draw
                # only for the region-seconds actually busy
                "energy_j": node.power.energy_j(
                    rep["pool"]["region_seconds"]
                    / max(1, rep["pool"]["n_regions"]),
                    rep["pool"]["region_seconds"]
                    * rep["pool"]["utilization"]),
            })
        from repro_torch.core.reporting import safe_rate, stamp
        from repro_torch.obs.metrics import trace_section
        from repro_torch.obs.slo import telemetry_section

        pct = Scheduler._percentile   # same nearest-rank estimator as the
        return stamp("cluster", {     # per-shell reports
            "cluster": True,
            "n_shells": len(self.nodes),
            "router": self.router.name,
            "rebalance": self.rebalance,
            "n_submitted": len(recs),
            "wall_s": wall,
            # rate over the RAW wall: a report taken before any completion
            # (wall == 0) emits 0.0, not an inf-like 1e9-scale rate
            "throughput_tps": safe_rate(counters["n_done"], raw_wall),
            "trace": trace_section(self.tracer),
            "telemetry": telemetry_section(self.metrics),
            "turnaround_p50_s": pct(turnarounds, 0.50),
            "turnaround_p99_s": pct(turnarounds, 0.99),
            "lost_tasks": counters["n_failed"],
            "dead_shells": sorted(self._dead_nodes),
            "failovers": len(counters["failover_events"]),
            "energy_j_total": sum(s["energy_j"]
                                  for s in per_shell.values()),
            **counters,
            "per_shell": per_shell,
        })
