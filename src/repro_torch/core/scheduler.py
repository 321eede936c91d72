"""Preemptive scheduler event loop, decomposed into three layers:

- **Policy** (``core/policy.py``): the queue discipline — which task runs
  next, which running task to preempt, which queued tasks to prefetch
  bitstreams for.  ``FcfsPriority`` is the paper's Algorithm 1 (§4.3) and
  stays the default; ``edf`` and ``wfq`` are drop-in alternatives.
- **Admission** (``core/submit.py``): ``submit(task) -> TaskHandle`` from
  any thread, ``run_forever()`` serving live traffic, graceful
  ``drain()``/``shutdown()``.  The paper's batch ``run(tasks_to_arrive)``
  is a compatibility wrapper that replays arrivals through ``submit()``.
- **Event loop** (this module): arrivals, dispatch, preemption plumbing,
  straggler mitigation (chunk-latency EWMA -> preempt & migrate), and
  region failure/repair.  Dispatch consults placement feasibility
  (``Task.footprint`` vs the region's device-slice width) through the
  policy's ``pick_region``.

Not ported yet, each with its own later slice: the flight recorder and
live metrics (``repro.obs``: the report's ``trace``/``telemetry`` sections
read ``{"enabled": False}``), the elastic region pool, cross-shell
handoffs, and scheduler checkpoints (``checkpoint_path`` raises).

Serve steps (paper):
  (1) find an available region;
  (2) none: if preemption enabled, ask the policy for a victim (FCFS: a
      region running a strictly lower-priority task; save context,
      re-enqueue);
  (3) if the loaded kernel differs, enqueue a reconfiguration (internal
      task);
  (4) launch; a previously stopped task has its context copied back first.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.interrupts import Event, EventKind
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.policy import (POLICY_NAMES, SchedulingPolicy, make_policy,
                               region_fits)
from repro_torch.core.reporting import safe_rate, stamp
from repro_torch.core.region import Region, RegionState
from repro_torch.core.shell import Shell
from repro_torch.core.submit import SubmissionQueue, TaskHandle
from repro_torch.core.task import N_PRIORITIES, Task, TaskStatus


@dataclass
class SchedulerConfig:
    preemption: bool = True
    n_priorities: int = N_PRIORITIES
    # queue discipline: "fcfs" (paper Algorithm 1, default), "edf"
    # (Task.deadline_s order), or "wfq" (per-Task.tenant fair share).
    policy: str = "fcfs"
    # wfq: relative tenant weights (unlisted tenants weigh 1.0)
    tenant_weights: Optional[dict] = None
    # full-reconfiguration baseline (paper §6.3): any kernel swap stalls ALL
    # regions and reloads the whole fabric.
    full_reconfig_mode: bool = False
    # straggler mitigation: preempt+migrate when a region's chunk EWMA
    # exceeds straggler_factor x the median of busy regions (None = off).
    straggler_factor: Optional[float] = None
    # auto-repair failed regions after this many seconds (None = stay dead).
    repair_after_s: Optional[float] = None
    checkpoint_path: Optional[str] = None  # not ported yet: must stay None
    # async bitstream prefetch: queued tasks (policy lookahead order) are
    # hinted to the shell's background prefetcher, which generates their
    # bitstreams off the dispatch path (the paper's latency-hiding §4.2).
    # None (default) follows Shell(prefetch=...), the single source of
    # truth; an explicit True/False here overrides it for this scheduler.
    prefetch: Optional[bool] = None
    # how many queued tasks (in policy dispatch order) to keep hinted
    prefetch_lookahead: int = 8
    # prefer dispatching to an idle region whose loaded bitstream already
    # matches the task (saves the partial reconfiguration entirely).
    bitstream_affinity: bool = True
    # same-bitstream task coalescing (DESIGN.md §8.3): when a region
    # finishes a task and the policy's lookahead holds a queued task with
    # the same executable key, dispatch it back-to-back on that region —
    # no release, no reconfig, no requeue round trip (the serving analogue
    # of continuous batching).  Policies only bend ordering *within* an
    # equivalence class (priority level / background set / tenant FIFO),
    # bounded by coalesce_window, so cross-class semantics are unchanged.
    coalescing: bool = True
    coalesce_window: int = 8
    # starvation bound (seconds): a queued task older than this is
    # *starving*.  The fcfs coalescing window refuses an intra-level jump
    # over a starving head, and the telemetry monitor's starvation
    # detector fires on it.  None = no bound (coalescing never refuses;
    # the detector falls back to its own default).
    starvation_bound_s: Optional[float] = None

    def validate(self) -> "SchedulerConfig":
        if self.n_priorities < 1:
            raise ValueError(
                f"n_priorities must be >= 1, got {self.n_priorities}")
        if self.checkpoint_path is not None:
            raise NotImplementedError(
                "scheduler checkpoints (repro.ckpt) are not ported yet; "
                "leave checkpoint_path=None")
        if self.prefetch_lookahead < 1:
            raise ValueError(
                f"prefetch_lookahead must be >= 1, got "
                f"{self.prefetch_lookahead}")
        if self.coalesce_window < 1:
            raise ValueError(
                f"coalesce_window must be >= 1, got {self.coalesce_window}")
        if self.starvation_bound_s is not None \
                and self.starvation_bound_s <= 0:
            raise ValueError(
                f"starvation_bound_s must be > 0 (or None), got "
                f"{self.starvation_bound_s}")
        if (self.policy or "").lower() not in POLICY_NAMES:
            raise ValueError(
                f"unknown scheduling policy {self.policy!r}; "
                f"known: {', '.join(POLICY_NAMES)}")
        for tenant, w in (self.tenant_weights or {}).items():
            if w <= 0:
                raise ValueError(
                    f"tenant_weights[{tenant!r}] must be > 0, got {w}")
        return self


class Scheduler:
    def __init__(self, shell: Shell, config: Optional[SchedulerConfig] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 pool=None):
        if pool is not None:
            raise NotImplementedError(
                "the elastic region pool (core/pool.py) is not ported yet")
        if config is not None and not isinstance(config, SchedulerConfig):
            raise TypeError(
                f"config must be a SchedulerConfig (or None), got "
                f"{type(config).__name__}")
        self.shell = shell
        self.cfg = (config or SchedulerConfig()).validate()
        if policy is None:
            policy = make_policy(self.cfg.policy,
                                 n_priorities=self.cfg.n_priorities,
                                 tenant_weights=self.cfg.tenant_weights)
        policy.affinity = self.cfg.bitstream_affinity
        self.policy = policy
        # completed Task objects (report() aggregates over them).  A
        # long-running server accumulates one entry per task; periodic
        # drain()+restart (or sampling report() and clearing) bounds it.
        self.finished: List[Task] = []
        self.failed: List[Task] = []
        self.t0 = 0.0
        self._preempt_pending = set()  # region ids with a preempt in flight
        # region ids whose TASK_DONE/TASK_PREEMPTED was just handled: the
        # worker raises the interrupt moments before retiring its inflight
        # count, so the region may still read busy when _serve runs — the
        # event itself proves it is free for redispatch.  Without this the
        # post-completion dispatch could stall a full WaitForInterrupt
        # timeout (0.5s) on an otherwise idle system.
        self._idle_hint = set()
        # running count of deadline misses (report() recomputes from the
        # finished list; the autoscaler reads this O(1) counter every tick)
        self.deadline_misses_total = 0
        self._dead_since = {}
        # debugging trace, bounded so server mode cannot grow it forever
        self.events_log: deque = deque(maxlen=65536)
        self.last_report: Optional[dict] = None

        # admission layer
        self._submissions = SubmissionQueue(wakeup=self._kick)
        # tid -> TaskHandle; mutated only by the loop thread, but report()
        # may scan it from a client thread, so mutations take this lock
        self._handles: dict = {}
        self._handles_lock = threading.Lock()
        self._arrivals: list = []         # heap of (arrival_time, seq, ...)
        self._seq = itertools.count()
        self._hinted = set()              # (tid, n_preemptions) already sent
        self._n_cancelled = 0
        self._stranded = 0
        # same-bitstream back-to-back dispatches (reconfig+requeue saved)
        self.coalesced_dispatches = 0
        self._running = False
        # serializes run_forever() startup against drain()/shutdown() so a
        # concurrent stop request cannot be erased mid-startup
        self._lifecycle_lock = threading.Lock()
        self._drain_req = threading.Event()
        self._stop_req = threading.Event()
        self._serving = threading.Event()
        self._loop_done = threading.Event()
        self._loop_done.set()             # no loop active yet

    # ------------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self.t0

    def _kick(self):
        """Wake a loop blocked in WaitForInterrupt (submission/drain)."""
        self.shell.interrupts.raise_interrupt(
            Event(EventKind.HEARTBEAT, -1))

    # -- admission layer -------------------------------------------------
    def submit(self, task: Task) -> TaskHandle:
        """Thread-safe online submission; the returned ``TaskHandle`` can
        be waited on (``result``), polled (``status``) or ``cancel``led
        while the task is still queued.  The handle resolves once a
        serving loop processes the task — submitting while no loop runs
        defers the work to the next ``run()``/``run_forever()``."""
        return self._submissions.submit(task)

    def run(self, tasks_to_arrive: List[Task], quiet: bool = True,
            handles: Optional[dict] = None) -> dict:
        """Paper batch mode (Algorithm 1): replay ``tasks_to_arrive``
        through ``submit()`` and drain.  Arrival times are honoured
        relative to this call, exactly as the seed scheduler did.
        ``handles`` (optional dict) collects ``tid -> TaskHandle`` so
        callers (e.g. the Controller) can event-wait on individual tasks
        instead of polling their status."""
        with self._lifecycle_lock:
            if self._running:
                raise RuntimeError("scheduler loop already running")
            self._submissions.reopen()  # batch reuse after a prior drain()
        for t in sorted(tasks_to_arrive, key=lambda t: t.arrival_time):
            h = self.submit(t)
            if handles is not None:
                handles[t.tid] = h
        return self.run_forever(quiet=quiet, drain=True)

    def run_forever(self, quiet: bool = True, drain: bool = False) -> dict:
        """Serve submissions until ``drain()``/``shutdown()`` (server mode)
        or until all submitted work completes (``drain=True``, batch
        mode).  Blocks; servers call it from a dedicated thread."""
        with self._lifecycle_lock:
            if self._running:
                raise RuntimeError("scheduler loop already running")
            self._running = True
            self._submissions.reopen()  # a prior drain()/shutdown() closed it
            self._stop_req.clear()
            if drain:
                self._drain_req.set()
            else:
                self._drain_req.clear()
            self._loop_done.clear()
        self.t0 = time.perf_counter()
        self._idle_hint.clear()
        self._serving.set()   # t0 is valid: now() / deadline_s make sense
        crashed = True
        try:
            self._loop(quiet)
            crashed = False
        finally:
            self._serving.clear()
            if crashed:
                # the loop died on an exception: a dead scheduler must not
                # keep accepting work (run() reopens after a repair)
                self._submissions.close()
            # teardown/crash/batch exit: this loop will never serve what
            # raced into the queue after its final empty() check —
            # resolve those handles as cancelled rather than strand them
            for _, handle in self._submissions.drain_new():
                handle.cancel()
            self._resolve_leftovers()
            self.last_report = self.report()
            self._running = False
            self._loop_done.set()
        return self.last_report

    @property
    def serving(self) -> bool:
        """True while a ``run``/``run_forever`` loop is live (its clock is
        valid and submissions are being served).  Cleared when the loop
        exits — including a crash — so cluster health checks can treat
        ``not serving`` on a started node as node death."""
        return self._serving.is_set()

    def wait_until_serving(self, timeout: Optional[float] = None) -> bool:
        """Block until a ``run_forever``/``run`` loop has started and its
        clock (``now()``, the reference for ``Task.deadline_s``) is valid.
        Clients that compute deadlines must call this after starting the
        server thread, or early deadlines are measured against a stale
        ``t0``."""
        return self._serving.wait(timeout)

    def drain(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Graceful stop: refuse new submissions, finish everything
        already submitted, then return that run's final report.  A no-op
        returning ``None`` if no loop ever ran (the scheduler stays
        usable); after an already-finished run it returns that run's
        report.  Server threads should ``wait_until_serving()`` before
        relying on drain to stop a loop that is only just starting."""
        with self._lifecycle_lock:
            if not self._running and self.last_report is None:
                return None
            self._submissions.close()
            self._drain_req.set()
        self._kick()
        if not self._loop_done.wait(timeout):
            raise TimeoutError(f"scheduler did not drain within {timeout}s")
        return self.last_report

    def shutdown(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Stop serving: refuse new submissions, cancel still-queued tasks
        (their handles resolve as cancelled), let running tasks finish.
        A no-op returning ``None`` if no loop ever ran; see ``drain`` for
        the startup-race caveat."""
        with self._lifecycle_lock:
            if not self._running and self.last_report is None:
                return None
            self._submissions.close()
            self._stop_req.set()
        self._kick()
        if not self._loop_done.wait(timeout):
            raise TimeoutError(f"scheduler did not stop within {timeout}s")
        return self.last_report

    # -- event loop ------------------------------------------------------
    def _loop(self, quiet: bool):
        while True:
            self._ingest_submissions()
            now = self.now()
            while self._arrivals and self._arrivals[0][0] <= now:
                _, _, task, handle = heapq.heappop(self._arrivals)
                self._admit(task, handle, quiet)

            if self._stop_req.is_set():
                self._cancel_queued()

            if (not self._arrivals and not self.policy.has_pending()
                    and not self._any_running()
                    and self._submissions.empty()
                    and (self._drain_req.is_set()
                         or self._stop_req.is_set())):
                break

            if (not any(r.alive for r in self.shell.regions)
                    and self.cfg.repair_after_s is None):
                n = len(self.policy.pending_tasks()) + len(self._arrivals)
                err = RuntimeError(
                    "all regions failed and auto-repair is disabled; "
                    f"{n} tasks stranded")
                self._fail_outstanding(err)
                raise err

            self._serve(quiet)
            self._check_stragglers()
            self._maybe_repair()

            timeout = ((self._arrivals[0][0] - self.now())
                       if self._arrivals else 0.5)
            ev = self.shell.interrupts.wait(max(1e-4, min(timeout, 0.5)))
            if ev is not None:
                self._handle(ev, quiet)

        # consume events that raced with the exit condition (a worker clears
        # current_task before its TASK_DONE interrupt is drained)
        for ev in self.shell.interrupts.drain():
            self._handle(ev, quiet)

    def _ingest_submissions(self):
        for task, handle in self._submissions.drain_new():
            with self._handles_lock:
                self._handles[task.tid] = handle
            heapq.heappush(self._arrivals,
                           (task.arrival_time, next(self._seq), task, handle))
        if len(self._handles) > 2048:
            with self._handles_lock:
                for tid, h in list(self._handles.items()):
                    if h.done():
                        if h.cancelled():
                            self._n_cancelled += 1
                        del self._handles[tid]

    def _admit(self, task: Task, handle: Optional[TaskHandle], quiet: bool):
        if task.t_arrived is None:  # a migrated-in task keeps its original
            task.t_arrived = time.perf_counter()  # arrival: turnaround is
        # measured end-to-end across shells, not per hop
        if not self._placement_feasible(task, handle):
            return
        self._enqueue(task)
        if not quiet:
            print(f"[{self.now():7.3f}] arrive {task}")

    def _placement_feasible(self, task: Task,
                            handle: Optional[TaskHandle]) -> bool:
        """Resolve the task's footprint (kernel default when unset) and
        reject at admission anything wider than any region that could ever
        exist — it would otherwise sit in a queue forever and hang
        ``drain()``.  A static shell can never re-cut its floorplan, so
        the ceiling is its widest region as built."""
        if task.footprint is None:
            try:
                task.footprint = get_kernel(task.kernel).footprint
            except KeyError:
                task.footprint = 1
        ceiling = max((len(r.devices) for r in self.shell.regions),
                      default=0)
        what = f"widest region ({ceiling} devices, static floorplan)"
        if task.footprint <= ceiling:
            return True
        task.status = TaskStatus.FAILED
        self.failed.append(task)
        err = ValueError(
            f"task #{task.tid} footprint {task.footprint} exceeds the "
            f"{what}; it can never be placed")
        if handle is not None:
            handle._fail(err)
        return False

    def _enqueue(self, task: Task, requeue: bool = False):
        handle = self._handles.get(task.tid)
        if handle is not None:
            if not handle._back_to_queue():
                return  # cancelled while off-queue; handle already resolved
        else:
            task.status = TaskStatus.QUEUED
        if requeue:
            self.policy.on_requeue(task)
        else:
            self.policy.enqueue(task)
        self._refresh_prefetch_hints()

    def _cancel_queued(self):
        """Stop path: resolve every not-yet-dispatched task as cancelled."""
        for _, _, task, handle in self._arrivals:
            if handle is not None:
                handle.cancel()
            else:
                task.status = TaskStatus.CANCELLED
        self._arrivals.clear()
        for task in self.policy.pending_tasks():
            handle = self._handles.get(task.tid)
            if handle is not None:
                handle.cancel()
            else:
                task.status = TaskStatus.CANCELLED
        for task, handle in self._submissions.drain_new():
            with self._handles_lock:
                self._handles[task.tid] = handle
            handle.cancel()

    def _fail_outstanding(self, exc: BaseException):
        for h in self._handles.values():
            if not h.done():
                h._fail(exc)

    def _resolve_leftovers(self):
        """No stranded TaskHandles: anything unresolved at loop exit is
        settled (done tasks resolve, the rest fail loudly)."""
        for tid, h in self._handles.items():
            if h.done():
                continue
            if h.task.status is TaskStatus.DONE:
                h._resolve()
            else:
                self._stranded += 1
                h._fail(RuntimeError(
                    f"task #{tid} stranded at scheduler exit "
                    f"(status={h.task.status.value})"))

    # -- prefetch plumbing ----------------------------------------------
    def _refresh_prefetch_hints(self):
        """Queue lookahead -> background bitstream generation (§4.2): warm
        bitstreams for the next tasks in *policy dispatch order*, for every
        geometry they could land on, while they wait in the queues."""
        prefetcher = getattr(self.shell, "prefetcher", None)
        if prefetcher is None:
            return
        enabled = self.cfg.prefetch
        if enabled is None:
            enabled = self.shell.prefetch_enabled
        if not enabled:
            return
        for task in self.policy.peek_for_prefetch(self.cfg.prefetch_lookahead):
            key = (task.tid, task.n_preemptions)
            if key in self._hinted:
                continue
            if not prefetcher.alive:  # lazy: the worker starts with the
                prefetcher.start()    # first hint, never idles otherwise
            prefetcher.submit(task, self.shell.geometries())
            self._hinted.add(key)
        if len(self._hinted) > 4096:
            self._hinted &= {(t.tid, t.n_preemptions)
                             for t in self.policy.pending_tasks()}

    # ------------------------------------------------------------------
    def _any_running(self) -> bool:
        return any(not r.idle for r in self.shell.regions if r.alive) or bool(
            self._preempt_pending)

    def _handle(self, ev: Event, quiet=True):
        self.events_log.append((self.now(), ev.kind.value, ev.region_id,
                                getattr(ev.task, "tid", None)))
        if ev.kind == EventKind.TASK_DONE:
            self.finished.append(ev.task)
            if ev.region_id in self._preempt_pending:
                # the victim finished before honouring the preempt: the
                # request is stale — clear it or the region is leaked as
                # 'preempting' forever (deadlock) and the flag would
                # insta-preempt the next task launched there.
                self._preempt_pending.discard(ev.region_id)
                self.shell.region(ev.region_id).cancel_preempt()
            if self.shell.region(ev.region_id).dispatchable:
                self._idle_hint.add(ev.region_id)  # draining/retired
                # regions never redispatch, so no hint to leak for them
            ev.task.deadline_missed = self._deadline_missed(ev.task)
            if ev.task.deadline_missed:
                self.deadline_misses_total += 1
            self.policy.on_task_done(ev.task)
            handle = self._handles.get(ev.task.tid)
            if handle is not None:
                handle._resolve()
            if not quiet:
                print(f"[{self.now():7.3f}] done   {ev.task} on R{ev.region_id}")
            # same-bitstream coalescing: redispatch this still-warm region
            # back-to-back before the general serve pass can requeue it
            self._try_coalesce(self.shell.region(ev.region_id), quiet)
        elif ev.kind == EventKind.TASK_PREEMPTED:
            self._preempt_pending.discard(ev.region_id)
            if self.shell.region(ev.region_id).dispatchable:
                self._idle_hint.add(ev.region_id)
            self._enqueue(ev.task, requeue=True)  # paper: enqueue the
            if not quiet:                         # stopped task
                print(f"[{self.now():7.3f}] preempt {ev.task} off R{ev.region_id}")
        elif ev.kind == EventKind.REGION_FAILED:
            region = self.shell.region(ev.region_id)
            self._preempt_pending.discard(ev.region_id)
            self._dead_since[ev.region_id] = self.now()
            task = ev.task
            if task is not None and task.status not in (TaskStatus.DONE,
                                                        TaskStatus.CANCELLED):
                # elastic recovery: resume from the region bank's last
                # committed context (survives the failure), else restart.
                # The commit must be THIS task's — a stale commit another
                # task left in the bank would resume into the wrong state.
                committed = region.bank.restore()
                if committed is not None and committed.tid not in (
                        None, task.tid):
                    committed = None
                task.saved_context = committed
                task.n_migrations += 1
                self._enqueue(task, requeue=True)
            if not quiet:
                print(f"[{self.now():7.3f}] REGION {ev.region_id} FAILED")
        # RECONFIG_DONE / HEARTBEAT: accounting only

    # ------------------------------------------------------------------
    def _serve(self, quiet=True):
        """Paper serve procedure, policy-mediated: dispatch while the
        policy can fill an idle region, then let it pick preemption
        victims for the queue heads still blocked."""
        dispatched = False
        while True:
            idle = [r for r in self.shell.regions
                    if r.dispatchable
                    and (r.idle or r.rid in self._idle_hint)
                    and r.rid not in self._preempt_pending]
            if not idle:
                break
            pick = self.policy.select(idle)
            if pick is None:
                break
            task, region = pick
            handle = self._handles.get(task.tid)
            if handle is not None and not handle._claim():
                continue  # lost the race against a client-side cancel()
            self._idle_hint.discard(region.rid)  # hint is single-use
            self._dispatch(region, task, quiet)
            dispatched = True
        if dispatched:
            self._refresh_prefetch_hints()
        if not self.cfg.preemption:
            return
        for candidate in self.policy.preempt_candidates():
            # draining regions are excluded: their task is already being
            # checkpoint-preempted by the pool's retirement path.  Only
            # regions the candidate could actually run on are victims —
            # preempting a region outside its pin set (or narrower than
            # its footprint) frees nothing the candidate can use.
            running = [r for r in self.shell.regions
                       if r.dispatchable
                       and r.rid not in self._preempt_pending
                       and region_fits(candidate, r)]
            victim = self.policy.choose_victim(candidate, running)
            if victim is not None:
                self._preempt_pending.add(victim.rid)
                victim.request_preempt()

    def _try_coalesce(self, region: Region, quiet=True) -> bool:
        """Same-bitstream task coalescing (DESIGN.md §8.3): the region just
        finished a task and still holds its bitstream; if the policy's
        window has a queued task with the same executable key (and the
        policy's cross-class semantics allow serving it now), dispatch it
        to this region immediately — skipping the release, the reconfig,
        and one event-loop round trip."""
        if (not self.cfg.coalescing or self._stop_req.is_set()
                or self.cfg.full_reconfig_mode  # keep the paper's baseline
                or region.loaded is None or not region.dispatchable
                or region.rid in self._preempt_pending):
            return False
        kernel, sig, _geom = region.loaded

        def matches(t: Task) -> bool:
            return t.kernel == kernel and t.args.signature() == sig

        task = self.policy.peek_same_bitstream(
            matches, region, self.cfg.coalesce_window,
            max_skip_wait_s=self.cfg.starvation_bound_s)
        if task is None or not self.policy.take(task):
            return False
        handle = self._handles.get(task.tid)
        if handle is not None and not handle._claim():
            return False  # lost the race against a client-side cancel()
        self._idle_hint.discard(region.rid)
        self.coalesced_dispatches += 1
        self._dispatch(region, task, quiet)
        self._refresh_prefetch_hints()
        if not quiet:
            print(f"[{self.now():7.3f}] coalesce {task} -> R{region.rid}")
        return True

    def _dispatch(self, region: Region, task: Task, quiet=True):
        task.last_dispatched_rid = region.rid
        key = (task.kernel, task.args.signature(), region.geometry)
        if self.cfg.full_reconfig_mode:
            if region.loaded != key:
                self._full_reconfigure(key, quiet)
                region.loaded = None  # force the (re)load below
        if region.loaded != key:
            region.enqueue_reconfig(task)
        region.enqueue_launch(task)
        if not quiet:
            print(f"[{self.now():7.3f}] launch {task} -> R{region.rid}")

    def _full_reconfigure(self, key, quiet=True):
        """Traditional full reconfiguration: stall the whole fabric.  Every
        running task is killed (non-preemptable baseline waits instead)."""
        # wait for all regions to drain (the FPGA cannot be reconfigured
        # while kernels run; this is exactly why full reconfig is slow)
        while any(not r.idle for r in self.shell.regions if r.alive):
            ev = self.shell.interrupts.wait(0.05)
            if ev is not None:
                self._handle(ev, quiet)
        self.shell.engine.full_reconfigure()
        for r in self.shell.regions:
            r.loaded = None
            r.executable = None

    # ------------------------------------------------------------------
    def _check_stragglers(self):
        f = self.cfg.straggler_factor
        if not f:
            return
        # baseline: every alive region with chunk history (idle regions
        # keep their EWMA — the straggler must not escape detection just
        # because its fast peers finished their tasks already)
        candidates = [r for r in self.shell.regions
                      if r.dispatchable and r.stats.chunks >= 3]
        if len(candidates) < 2:
            return
        busy = [r for r in candidates if r.current_task is not None]
        lat = sorted(r.stats.chunk_ewma_s for r in candidates)
        median = lat[(len(lat) - 1) // 2]  # lower-middle of all candidates
        if median <= 0:
            return
        for r in busy:
            if (r.stats.chunk_ewma_s > f * median
                    and r.rid not in self._preempt_pending):
                t = r.current_task
                if t is not None:
                    t.n_migrations += 1
                    self._preempt_pending.add(r.rid)
                    r.request_preempt()  # -> re-enqueued, served elsewhere

    def _maybe_repair(self):
        if self.cfg.repair_after_s is None:
            return
        for rid, t_dead in list(self._dead_since.items()):
            if self.now() - t_dead >= self.cfg.repair_after_s:
                region = self.shell.region(rid)
                if region.state is not RegionState.RETIRED:
                    # launch commands that were still queued on the dead
                    # worker were dispatched but never ran — requeue them
                    # (repair's single-lock drain hands them back instead
                    # of silently dropping a racing enqueue).  A task whose
                    # failure fired during its *reconfig* command was
                    # already requeued by the REGION_FAILED handler while
                    # its launch command still sat in the queue: skip
                    # anything already pending or the same Task would be
                    # dispatched twice concurrently.
                    dropped = region.repair()
                    if dropped:
                        pending = self.policy.pending_tasks()
                        for task in dropped:
                            # a never-started launch is still QUEUED; any
                            # other status means the task moved on (done,
                            # cancelled, or already running elsewhere)
                            if task.status is not TaskStatus.QUEUED:
                                continue
                            if any(t is task for t in pending):
                                continue  # REGION_FAILED requeued it
                            if task.last_dispatched_rid != rid:
                                # requeued by the failure handler AND
                                # already re-dispatched to another region
                                # (whose worker may not have started it
                                # yet): this drained command is stale
                                continue
                            self._enqueue(task, requeue=True)
                del self._dead_since[rid]

    # ------------------------------------------------------------------
    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[i]

    def _deadline_missed(self, t: Task) -> bool:
        """Valid only while the run that served ``t`` is the current one;
        completed tasks carry the verdict in ``t.deadline_missed``."""
        return (t.deadline_s is not None and t.t_done is not None
                and (t.t_done - self.t0) > t.deadline_s)

    def report(self) -> dict:
        tasks = self.finished
        # live queue-wait ages (starvation visibility): the oldest queued
        # task per priority level and per tenant, right now
        now_pc = time.perf_counter()
        wait_by_prio: dict = {}
        wait_by_tenant: dict = {}
        for t in self.policy.pending_tasks():
            if t.t_arrived is None:
                continue
            w = max(now_pc - t.t_arrived, 0.0)
            wait_by_prio[t.priority] = max(
                wait_by_prio.get(t.priority, 0.0), w)
            wait_by_tenant[t.tenant] = max(
                wait_by_tenant.get(t.tenant, 0.0), w)
        per_prio = {}
        for p in range(self.cfg.n_priorities):
            st = [t.service_time for t in tasks
                  if t.priority == p and t.service_time is not None]
            per_prio[p] = {
                "n": len(st),
                "mean_service_s": sum(st) / len(st) if st else 0.0,
                "max_service_s": max(st) if st else 0.0,
                "max_queue_wait_s": wait_by_prio.get(p, 0.0),
            }
        span = max((t.t_done for t in tasks if t.t_done), default=self.t0)
        raw_wall = span - self.t0
        wall = max(raw_wall, 1e-9)

        # policy-level metrics: turnaround percentiles, deadlines, fairness
        turnarounds = sorted(t.turnaround for t in tasks
                             if t.turnaround is not None)
        deadline_tasks = [t for t in tasks if t.deadline_s is not None]
        weights = getattr(self.policy, "weights", {}) or {}
        per_tenant = {}
        for t in tasks:
            d = per_tenant.setdefault(t.tenant, {
                "n": 0, "work_s": 0.0, "deadline_misses": 0,
                "turnarounds": []})
            d["n"] += 1
            d["work_s"] += t.run_s
            d["turnarounds"].append(t.turnaround or 0.0)
            if t.deadline_missed:
                d["deadline_misses"] += 1
        # tenants with only queued (never-finished) work still show up —
        # exactly the starving-victim case the wait ages are for
        for tenant in wait_by_tenant:
            per_tenant.setdefault(tenant, {
                "n": 0, "work_s": 0.0, "deadline_misses": 0,
                "turnarounds": []})
        shares = []
        for tenant, d in per_tenant.items():
            ts = sorted(d.pop("turnarounds"))
            d["turnaround_p50_s"] = self._percentile(ts, 0.50)
            d["turnaround_p99_s"] = self._percentile(ts, 0.99)
            d["share"] = d["work_s"] / weights.get(tenant, 1.0)
            d["max_queue_wait_s"] = wait_by_tenant.get(tenant, 0.0)
            if d["n"] > 0:  # fairness is over tenants actually served
                shares.append(d["share"])
        if len(shares) >= 2 and min(shares) > 0:
            fairness = max(shares) / min(shares)
        elif len(shares) >= 2:
            fairness = float("inf")
        else:
            fairness = 1.0

        with self._handles_lock:  # the loop thread may be pruning handles
            live_cancelled = sum(1 for h in self._handles.values()
                                 if h.cancelled())

        # capacity accounting: region-seconds is capacity consumed over
        # the run's wall window (static n-region shell = n * wall);
        # utilization divides the busy time actually attributed to regions
        # by that capacity
        pool_stats = {
            "elastic": False,
            "n_regions": len(self.shell.regions),
            "grows": 0, "shrinks": 0, "resizes": 0,
            "resize_events": [],
            "region_seconds": len(self.shell.regions) * wall,
        }
        regions_ever = list(self.shell._by_rid.values())
        busy_total = sum(r.stats.busy_s for r in regions_ever)
        pool_stats["utilization"] = (
            busy_total / pool_stats["region_seconds"]
            if pool_stats["region_seconds"] > 0 else 0.0)
        es = self.shell.engine.stats
        # nested detail carries only what the top-level keys don't: one
        # source of truth per number (the two are sampled at different
        # moments and could otherwise disagree within one report)
        detail = self.shell.reconfig_report()
        for dup in ("partial_loads", "cache_hits", "cold_compiles",
                    "prefetch_compiles", "prefetch_hits",
                    "prefetch_hit_rate", "prefetch_stale_drops",
                    "evictions", "full_reconfigs", "total_stall_s"):
            detail.pop(dup, None)
        return stamp("scheduler", {
            "n_done": len(tasks),
            "wall_s": wall,
            # rate over the RAW wall: an instant window (CI smoke with no
            # completions) reports 0.0 instead of an inf-like 1e9 rate
            "throughput_tps": safe_rate(len(tasks), raw_wall),
            "policy": self.policy.name,
            "service_by_priority": per_prio,
            "turnaround_p50_s": self._percentile(turnarounds, 0.50),
            "turnaround_p99_s": self._percentile(turnarounds, 0.99),
            "deadline_tasks": len(deadline_tasks),
            "deadline_misses": sum(t.deadline_missed
                                   for t in deadline_tasks),
            "per_tenant": per_tenant,
            "fairness_ratio": fairness,
            "cancelled": self._n_cancelled + live_cancelled,
            "stranded_handles": self._stranded,
            "preemptions": sum(t.n_preemptions for t in tasks),
            "migrations": sum(t.n_migrations for t in tasks),
            # chunk-pipeline + coalescing accounting (DESIGN.md §8)
            "chunks": sum(r.stats.chunks for r in regions_ever),
            "chunks_pipelined": sum(r.stats.chunks_pipelined
                                    for r in regions_ever),
            "chunks_discarded": sum(r.stats.chunks_discarded
                                    for r in regions_ever),
            "host_spills_avoided": sum(r.stats.host_spills_avoided
                                       for r in regions_ever),
            "coalesced_dispatches": self.coalesced_dispatches,
            "reconfigs": es.partial_loads,
            "full_reconfigs": es.full_reconfigs,
            "cache_hits": es.cache_hits,
            "cold_compiles": es.cold_compiles,
            "prefetch_compiles": es.prefetch_compiles,
            "prefetch_hits": es.prefetch_hits,
            "prefetch_hit_rate": es.prefetch_hit_rate(),
            "prefetch_stale_drops": es.prefetch_stale_drops,
            "evictions": es.evictions,
            "dispatch_stall_s": es.total_stall_s,
            "pool": pool_stats,
            "reconfig": detail,
            "trace": {"enabled": False},
            "telemetry": {"enabled": False},
        })
