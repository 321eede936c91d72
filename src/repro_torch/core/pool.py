"""Elastic region pool: add/retire regions at runtime + load-driven autoscaling.

The paper fixes the number of Reconfigurable Regions when the shell is
built; this module makes the pool itself a scheduled resource (DESIGN.md
§6).  A ``RegionPool`` grows the shell with new regions (floorplanned out
of free devices, carved from idle regions' slices, or time-shared when the
grid overlaps) and retires regions with a *safe drain*: the region is taken
out of dispatch, its running task is checkpoint-preempted through the
ordinary cooperative-preemption machinery (``core/preemption.py`` budget
chunks + ``ContextBank`` commit), the scheduler requeues it via
``policy.on_requeue``, and only once the region is idle is it actually shut
down and its devices returned to the floorplanner.

On top sits the ``Autoscaler``: a deterministic control loop fed by the
scheduler each event-loop tick (queue depth, rolling turnaround p99,
deadline misses — the same signals ``Scheduler.report()`` exposes) that
decides grow/shrink/hold with hysteresis (a resize cooldown plus a
sustained-idle grace period before any shrink) and hard min/max bounds.
All pool mutation happens on the scheduler's event-loop thread —
``request_grow``/``request_shrink`` are the only thread-safe entry points,
and they just leave a note for the next tick.

A copy of the reference's ``core/pool.py``, behaviour unchanged.  On one
card the grid is ``[cuda:0]`` with ``allow_overlap=True``: ``grow`` adds a
region that time-shares the card (a new CUDA stream), and ``replan`` and
``_rescue_placement`` do nothing, because the floorplan is overlapped.  On
the CPU, ``devices=["cpu"] * n`` gives ``n`` distinct device objects, and
the floorplanner (which keys on ``id(d)``) cuts them like a real grid.  The
``tracer``/``metrics`` hooks read the shell's (``Shell(tracer=,
metrics=)``): resizes go on the ``("pool", 0)`` track as ``pool_resize``
events and count in ``pool_resizes_total``. Section references ("DESIGN.md
§6") point at the reference's ``DESIGN.md`` at the repository root.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.floorplan import partition_widths, widths_for_footprints
from repro_torch.core.region import Region
from repro_torch.core.shell import Shell


@dataclass
class AutoscalerConfig:
    min_regions: int = 1
    max_regions: int = 4
    # grow when queued tasks per dispatchable region exceed this
    grow_queue_depth: float = 2.0
    # grow when the rolling turnaround p99 exceeds this (None = ignore)
    target_p99_s: Optional[float] = None
    # any *new* deadline miss since the last decision also triggers a grow
    grow_on_deadline_miss: bool = True
    # shrink only after the pool has been quiet (empty queue, >=1 idle
    # region) for this long — the idle-side hysteresis
    idle_grace_s: float = 0.5
    # minimum time between two resize decisions — the resize-side hysteresis
    cooldown_s: float = 0.5
    # rolling window (completed tasks) for the p99 signal
    window: int = 16

    def validate(self) -> "AutoscalerConfig":
        if self.min_regions < 1:
            raise ValueError(
                f"min_regions must be >= 1, got {self.min_regions}")
        if self.max_regions < self.min_regions:
            raise ValueError(
                f"max_regions ({self.max_regions}) must be >= min_regions "
                f"({self.min_regions})")
        if self.grow_queue_depth <= 0:
            raise ValueError(
                f"grow_queue_depth must be > 0, got {self.grow_queue_depth}")
        if self.idle_grace_s < 0 or self.cooldown_s < 0:
            raise ValueError("idle_grace_s / cooldown_s must be >= 0")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        return self


@dataclass
class PoolSignals:
    """One tick's worth of load signals (all cheap to gather)."""
    now: float                 # scheduler clock (seconds since loop start)
    n_regions: int             # dispatchable regions
    n_idle: int                # dispatchable AND idle
    queue_depth: int           # tasks pending in the policy queues
    p99_s: float = 0.0         # rolling turnaround p99 over the window
    deadline_misses: int = 0   # cumulative deadline misses so far


class Autoscaler:
    """Pure decision logic: ``decide(signals) -> +1 | 0 | -1``.

    Grow pressure: queue depth per region above ``grow_queue_depth``, p99
    above ``target_p99_s``, or a fresh deadline miss.  Shrink: the queue has
    been empty with at least one idle region for ``idle_grace_s``.  Both
    directions respect ``cooldown_s`` and the min/max bounds, so a bursty
    arrival trace cannot make the pool thrash.
    """

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.cfg = (config or AutoscalerConfig()).validate()
        self._last_resize: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._seen_misses = 0

    def decide(self, s: PoolSignals) -> int:
        cfg = self.cfg
        quiet = s.queue_depth == 0 and s.n_idle >= 1
        if not quiet:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = s.now
        if (self._last_resize is not None
                and s.now - self._last_resize < cfg.cooldown_s):
            return 0

        new_misses = s.deadline_misses - self._seen_misses
        self._seen_misses = s.deadline_misses
        pressure = s.queue_depth > cfg.grow_queue_depth * max(s.n_regions, 1)
        if cfg.target_p99_s is not None and s.p99_s > cfg.target_p99_s:
            pressure = True
        if cfg.grow_on_deadline_miss and new_misses > 0:
            pressure = True
        if pressure and s.n_regions < cfg.max_regions:
            self._last_resize = s.now
            self._idle_since = None
            return +1

        if (quiet and s.n_regions > cfg.min_regions
                and self._idle_since is not None
                and s.now - self._idle_since >= cfg.idle_grace_s):
            self._last_resize = s.now
            self._idle_since = None
            return -1
        return 0


class RegionPool:
    """Runtime-elastic view over a ``Shell``'s region list.

    Constructed around an existing shell (whose initial regions seed the
    pool) and handed to the ``Scheduler`` (``Scheduler(shell, cfg,
    pool=pool)``), which calls ``tick()`` once per event-loop iteration on
    the loop thread.  Everything here other than ``request_*`` assumes it
    runs on that thread.
    """

    def __init__(self, shell: Shell,
                 autoscaler: Optional[Autoscaler] = None,
                 min_regions: int = 1, max_regions: Optional[int] = None):
        self.shell = shell
        self.autoscaler = autoscaler
        if autoscaler is not None:
            min_regions = autoscaler.cfg.min_regions
            max_regions = autoscaler.cfg.max_regions
        self.min_regions = max(1, min_regions)
        self.max_regions = (max_regions if max_regions is not None
                            else max(len(shell.regions), self.min_regions))
        self.grows = 0
        self.shrinks = 0
        # (wall perf_counter, kind, rid, n_regions_after)
        self.resize_events: deque = deque(maxlen=256)
        # rid -> [activated_at, retired_at | None] (perf_counter timestamps)
        self._spans: Dict[int, list] = {
            r.rid: [time.perf_counter(), None] for r in shell.regions}
        self._draining: Dict[int, Region] = {}
        self._req_lock = threading.Lock()
        self._req_grow = 0
        self._req_shrink: List[Optional[int]] = []

    # -- thread-safe external requests (tests, CLI, operators) -----------
    def request_grow(self, n: int = 1) -> None:
        with self._req_lock:
            self._req_grow += max(1, int(n))

    def request_shrink(self, rid: Optional[int] = None) -> None:
        """Ask the next tick to drain+retire a region (a specific one by
        id, or let the pool pick a victim)."""
        with self._req_lock:
            self._req_shrink.append(rid)

    # -- sizing ----------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(1 for r in self.shell.regions
                   if r.rid not in self._draining)

    @property
    def draining_rids(self) -> List[int]:
        return list(self._draining)

    def grow(self, width: int = 1,
             footprints: Optional[List[int]] = None) -> Optional[Region]:
        """Add one region (loop thread only).  Returns ``None`` at the max
        bound or when no devices can be found for it.  ``footprints``
        (the pending workload's widths) steer the replan that follows, so
        a region grown for a wide task is not immediately re-cut narrow."""
        if self.n_active >= self.max_regions:
            return None
        fp = self.shell.floorplanner
        try:
            if fp.free_devices():
                region = self.shell.add_region(width=width)
            else:
                # no free devices: prefer carving a slice out of the idle
                # regions' devices (give the new region a placeholder and
                # let the replan below cut the grid into len(idle)+1
                # slices) — overlap is the last resort, because once any
                # slice time-shares the grid the floorplan can never go
                # back to disjoint (Floorplanner.overlapped is one-way)
                idle = [r for r in self.shell.regions
                        if r.dispatchable and r.idle
                        and r.rid not in self._draining]
                spare = sum(len(fp.assignment(r.rid) or ())
                            for r in idle) - len(idle)
                if spare >= 1 and not fp.overlapped:
                    region = self.shell.add_region(devices=[])
                elif fp.allow_overlap:
                    region = self.shell.add_region(width=width)
                else:
                    return None
        except ValueError:
            return None
        self._spans[region.rid] = [time.perf_counter(), None]
        self.grows += 1
        self.resize_events.append(
            (time.perf_counter(), "grow", region.rid, self.n_active))
        tr = getattr(self.shell, "tracer", None)
        if tr is not None:
            tr.emit("pool_resize", ("pool", 0), direction="grow",
                    rid=region.rid, n_regions=self.n_active)
        m = getattr(self.shell, "metrics", None)
        if m is not None:
            m.counter("pool_resizes_total", direction="grow").inc()
        self.replan(footprints if footprints is not None else [width])
        return region

    def begin_retire(self, region: Region, scheduler=None) -> None:
        """Start a safe drain: no new dispatches, checkpoint-preempt the
        running task (it re-enters the queues via ``policy.on_requeue``
        when the TASK_PREEMPTED interrupt lands)."""
        if region.rid in self._draining:
            return
        region.begin_drain()
        self._draining[region.rid] = region
        if not region.idle:
            if scheduler is not None:
                # the in-flight preempt keeps _any_running() true until its
                # interrupt is handled, so a drain() cannot exit under it
                scheduler._preempt_pending.add(region.rid)
            region.request_preempt()

    def pick_victim(self, scheduler=None) -> Optional[Region]:
        """Region to retire on a shrink: idle regions first; otherwise the
        one running the least-urgent task (largest priority number)."""
        pending = getattr(scheduler, "_preempt_pending", set()) or set()
        candidates = [r for r in self.shell.regions
                      if r.rid not in self._draining
                      and r.rid not in pending and r.alive]
        if len(candidates) == 0 or self.n_active <= self.min_regions:
            return None
        idle = [r for r in candidates if r.idle]
        if idle:
            return idle[-1]  # newest idle region first (LIFO keeps rids low)
        def urgency(r):
            t = r.current_task
            return t.priority if t is not None else -1
        return max(candidates, key=urgency)

    def finalize_retirements(self, scheduler=None,
                             footprints: tuple = ()) -> List[int]:
        """Retire draining regions that have gone idle (or died): shut the
        worker down, return the devices to the floorplanner, widen the
        surviving idle regions over the freed slice.

        Deliberately does NOT clear the region's ``_preempt_pending``
        marker: that marker is the drain-exit guard — it keeps
        ``Scheduler._any_running()`` true until the region's final
        TASK_PREEMPTED/TASK_DONE interrupt is handled (which requeues or
        finishes the task and clears the marker itself).  Clearing it here
        could let a concurrent ``drain()`` exit with the event still in
        the queue and strand the task's handle.
        """
        done = []
        for rid, region in list(self._draining.items()):
            if not (region.idle or not region.alive):
                continue
            self.shell.retire_region(rid)
            del self._draining[rid]
            span = self._spans.get(rid)
            if span is not None:
                span[1] = time.perf_counter()
            self.shrinks += 1
            self.resize_events.append(
                (time.perf_counter(), "shrink", rid, self.n_active))
            tr = getattr(self.shell, "tracer", None)
            if tr is not None:
                tr.emit("pool_resize", ("pool", 0), direction="shrink",
                        rid=rid, n_regions=self.n_active)
            m = getattr(self.shell, "metrics", None)
            if m is not None:
                m.counter("pool_resizes_total", direction="shrink").inc()
            if scheduler is not None:
                scheduler._dead_since.pop(rid, None)
                scheduler._idle_hint.discard(rid)
            done.append(rid)
        if done:
            self.replan(footprints)
        return done

    # -- floorplan replanning -------------------------------------------
    def replan(self, footprints: tuple = ()) -> Dict[int, list]:
        """Re-cut the slices of *idle, dispatchable* regions so that, with
        the busy/draining regions' slices held fixed, the whole grid is
        covered again (DESIGN.md §6.2).  Slice widths are matched to the
        pending workload's ``footprints`` (widest first; near-equal when
        none are declared), so a region grown for a wide task keeps its
        width instead of being re-cut narrow.  Geometry changes invalidate
        the region's loaded bitstream (the cache key includes the
        geometry).  No-op once slices overlap — there is nothing to
        redistribute on a time-shared grid."""
        fp = self.shell.floorplanner
        if fp.overlapped:
            return {}
        idle = [r for r in self.shell.regions
                if r.dispatchable and r.idle and r.rid not in self._draining]
        if not idle:
            return {}
        fixed = {id(d) for r in self.shell.regions if r not in idle
                 for d in (fp.assignment(r.rid) or ())}
        pool_devs = [d for d in self.shell.devices if id(d) not in fixed]
        if len(pool_devs) < len(idle):
            return {}  # cannot give every idle region a disjoint slice
        widths = widths_for_footprints(footprints, len(idle), len(pool_devs))
        changed = {}
        for region, devs in zip(idle, partition_widths(pool_devs, widths)):
            old = fp.assignment(region.rid) or []
            if [id(d) for d in devs] == [id(d) for d in old]:
                continue
            fp.bind(region.rid, devs)
            region.devices = list(devs)
            region.geometry = (len(devs),)
            region.loaded = None     # geometry is part of the bitstream key
            region.executable = None
            changed[region.rid] = list(devs)
        return changed

    # -- the control loop (called from the scheduler's event loop) -------
    def tick(self, scheduler) -> None:
        with self._req_lock:
            n_grow = self._req_grow
            self._req_grow = 0
            shrink_reqs = self._req_shrink
            self._req_shrink = []

        # one pending-queue scan per tick, shared by every consumer below
        pending = scheduler.policy.pending_tasks()
        footprints = [t.footprint or 1 for t in pending]
        want_width = max(footprints, default=1)

        for _ in range(n_grow):
            self.grow(width=want_width, footprints=footprints)
        for rid in shrink_reqs:
            if self.n_active <= self.min_regions:
                break
            region = (self.shell._by_rid.get(rid) if rid is not None
                      else self.pick_victim(scheduler))
            if region is not None and region.rid not in self._draining:
                self.begin_retire(region, scheduler)

        if self.autoscaler is not None:
            decision = self.autoscaler.decide(
                self.signals(scheduler, queue_depth=len(pending)))
            if decision > 0:
                self.grow(width=want_width, footprints=footprints)
            elif decision < 0:
                victim = self.pick_victim(scheduler)
                if victim is not None:
                    self.begin_retire(victim, scheduler)

        self._rescue_placement(scheduler, footprints)
        self.finalize_retirements(scheduler, footprints)

    def _rescue_placement(self, scheduler, footprints) -> None:
        """A pending task wider than every current region would starve in
        the queues (placement-infeasible on this floorplan, though not on
        the grid — admission already rejected anything genuinely
        unachievable).  Consolidate: first try a footprint-matched replan
        of the idle slices; if the region count itself is the obstacle,
        drain the narrower idle regions — never below ``min_regions`` —
        so the next replan has fewer, wider slices.  Repeated ticks
        converge as busy regions drain.  No-op on an overlapped
        (time-shared) grid, where every region already spans the devices
        it can span."""
        fp = self.shell.floorplanner
        if fp.overlapped:
            return
        regions = [r for r in self.shell.regions
                   if r.dispatchable and r.rid not in self._draining]
        if not regions:
            return
        need = max(footprints, default=0)
        if (need <= max(len(r.devices or ()) for r in regions)
                or need > len(self.shell.devices)):
            return
        if len(fp.free_devices()) >= need and self.n_active < self.max_regions:
            self.grow(width=need, footprints=footprints)
            return
        idle = [r for r in regions if r.idle]
        if not idle:
            return
        self.replan(footprints)
        if need <= max(len(r.devices or ()) for r in idle):
            return
        # too many slices for the grid: shed the narrowest idle regions
        for r in sorted(idle, key=lambda r: len(r.devices or ()))[:-1]:
            if self.n_active <= self.min_regions:
                break
            self.begin_retire(r, scheduler)

    def signals(self, scheduler,
                queue_depth: Optional[int] = None) -> PoolSignals:
        regions = [r for r in self.shell.regions
                   if r.dispatchable and r.rid not in self._draining]
        window = (self.autoscaler.cfg.window
                  if self.autoscaler is not None else 16)
        tail = scheduler.finished[-window:]
        turnarounds = sorted(t.turnaround for t in tail
                             if t.turnaround is not None)
        p99 = scheduler._percentile(turnarounds, 0.99)
        if queue_depth is None:
            queue_depth = len(scheduler.policy.pending_tasks())
        return PoolSignals(
            now=scheduler.now(),
            n_regions=len(regions),
            n_idle=sum(1 for r in regions if r.idle),
            queue_depth=queue_depth,
            p99_s=p99,
            # O(1): the scheduler counts misses as TASK_DONE events land (a
            # full rescan of `finished` every tick would be O(n^2) over a
            # long-running server)
            deadline_misses=scheduler.deadline_misses_total)

    # -- accounting ------------------------------------------------------
    def region_seconds(self, t0: float, t1: float) -> float:
        """Capacity consumed in the wall-clock window [t0, t1]: the sum over
        every region (including retired ones) of its active overlap with
        the window.  A static n-region shell integrates to n * (t1 - t0)."""
        total = 0.0
        for start, end in self._spans.values():
            lo = max(start, t0)
            hi = min(end if end is not None else t1, t1)
            if hi > lo:
                total += hi - lo
        return total

    def report(self, t0: Optional[float] = None,
               t1: Optional[float] = None) -> dict:
        now = time.perf_counter()
        if t0 is None:
            t0 = min((s[0] for s in self._spans.values()), default=now)
        if t1 is None:
            t1 = now
        return {
            "elastic": True,
            "n_regions": self.n_active,
            "min_regions": self.min_regions,
            "max_regions": self.max_regions,
            "draining": len(self._draining),
            "grows": self.grows,
            "shrinks": self.shrinks,
            "resizes": self.grows + self.shrinks,
            "resize_events": [
                {"kind": kind, "rid": rid, "n_regions": n,
                 "t_s": max(0.0, t - t0)}
                for (t, kind, rid, n) in self.resize_events],
            "region_seconds": self.region_seconds(t0, t1),
        }
