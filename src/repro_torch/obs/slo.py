"""Per-tenant SLO evaluation, burn-rate alerting, and live detectors
(DESIGN.md §12).

A :class:`TelemetryMonitor` is a periodic sampler over a
:class:`~repro_torch.obs.registry.MetricsRegistry` plus the live objects
attached to it (schedulers, shells, cluster frontends, serving engines).
Each tick it:

1. polls gauges no event site can maintain (queue depth and max
   queue-wait age per priority/tenant, per-region occupancy, pool size,
   node health, and ``NodePowerModel`` joules);
2. runs the detectors —
   - **starvation**: any queued task whose wait age exceeds the bound
     (``SchedulerConfig.starvation_bound_s`` when set, else the
     detector default);
   - **convoy**: windowed p99 *slowdown* (turnaround / ideal service
     time) of a size class exceeds a threshold — the FIFO-convoy
     signature, small tasks serialized behind large ones;
   - **preemption-response regression**: windowed p99 of the
     request→honored latency exceeds a target;
3. evaluates per-tenant :class:`SloPolicy` objects with multi-window
   burn-rate alerting (Google SRE style): an alert fires only when the
   error budget burns faster than ``burn_threshold`` over *both* the
   short and the long window, so a single slow request cannot page;
4. maintains the firing/resolved alert state machine and pushes a full
   snapshot to any attached sinks (JSONL stream, see ``obs/exporter.py``).

``sample()`` is callable directly (no thread) so tests and CI drive
ticks deterministically; ``start()`` runs it on a daemon thread.

A copy of the reference's ``repro.obs.slo``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.obs.registry import MetricsRegistry

# Size classes for the convoy detector, keyed off a task's ideal service
# time (its pure execution time): convoys show up as *short* tasks with
# turnarounds many multiples of their service time.
_SIZE_EDGES = ((0.01, "short"), (0.1, "medium"))


def size_class(ideal_s: float) -> str:
    for edge, label in _SIZE_EDGES:
        if ideal_s < edge:
            return label
    return "long"


@dataclass
class SloPolicy:
    """One tenant's latency objective with a multi-window burn budget.

    ``miss_budget`` is the fraction of requests allowed to exceed the
    target; the *burn rate* over a window is (observed bad fraction) /
    ``miss_budget``, so burn 1.0 consumes the budget exactly, and the
    alert fires when both windows burn faster than ``burn_threshold``.
    ``tenant="*"`` applies to every tenant observed.
    """

    tenant: str = "*"
    latency_target_s: Optional[float] = None  # turnaround objective
    ttft_target_s: Optional[float] = None     # serving TTFT objective
    miss_budget: float = 0.05
    short_window_s: float = 5.0
    long_window_s: float = 30.0
    burn_threshold: float = 2.0

    def validate(self) -> "SloPolicy":
        if not (0.0 < self.miss_budget <= 1.0):
            raise ValueError(
                f"miss_budget must be in (0, 1], got {self.miss_budget}")
        if self.short_window_s <= 0 or self.long_window_s <= 0:
            raise ValueError("SLO windows must be positive")
        if self.short_window_s > self.long_window_s:
            raise ValueError(
                f"short_window_s ({self.short_window_s}) must not exceed "
                f"long_window_s ({self.long_window_s})")
        if self.burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}")
        return self


@dataclass
class DetectorConfig:
    """Thresholds for the three built-in detectors.  ``None`` disables a
    detector outright (the synthetic-trace CI asserts each detector can
    fire *alone* under a config that silences the others)."""

    starvation_bound_s: Optional[float] = 5.0
    convoy_slowdown: Optional[float] = 8.0   # windowed p99 slowdown ratio
    convoy_min_tasks: int = 6
    convoy_window_s: float = 30.0
    preempt_response_target_s: Optional[float] = None
    preempt_min_samples: int = 5
    preempt_window_s: float = 30.0


def _pctl(xs: "list[float]", q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


class TelemetryMonitor:
    """Periodic sampler + SLO/detector evaluator over one registry."""

    _ALERT_HISTORY = 256

    def __init__(self, registry: MetricsRegistry,
                 policies: "Optional[List[SloPolicy]]" = None,
                 detectors: Optional[DetectorConfig] = None,
                 interval_s: float = 0.5):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        registry.monitor = self
        self.policies = [p.validate() for p in (policies or [])]
        self.detectors = detectors or DetectorConfig()
        self.interval_s = interval_s
        self._sinks: list = []
        # attached sources: (obj, labels) pairs
        self._scheds: list = []
        self._shells: list = []
        self._clusters: list = []
        self._servings: list = []
        # alert state machine: key -> firing alert dict
        self._firing: dict = {}
        self._resolved: deque = deque(maxlen=self._ALERT_HISTORY)
        self.n_fired = 0          # distinct alert activations, cumulative
        self.n_samples = 0
        self._detector_state: dict = {}
        self._slo_state: dict = {}
        self._busy_prev: dict = {}   # (id(shell), rid) -> (t, busy_s)
        self._node_t0: dict = {}     # id(node) -> first-seen perf_counter
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring ----------------------------------------------------------

    def attach(self, scheduler=None, shell=None, cluster=None,
               serving=None, **labels) -> "TelemetryMonitor":
        """Register live objects to poll.  ``cluster`` implies its nodes'
        schedulers and shells (labeled ``shell=<node_id>``)."""
        if scheduler is not None:
            self._scheds.append((scheduler, dict(labels)))
            sh = getattr(scheduler, "shell", None)
            if sh is not None:
                self._shells.append((sh, dict(labels)))
        if shell is not None:
            self._shells.append((shell, dict(labels)))
        if cluster is not None:
            self._clusters.append((cluster, dict(labels)))
            for node in getattr(cluster, "nodes", ()):
                nl = dict(labels, shell=str(node.node_id))
                self._scheds.append((node.scheduler, nl))
                self._shells.append((node.shell, nl))
        if serving is not None:
            self._servings.append((serving, dict(labels)))
        return self

    def add_sink(self, sink) -> None:
        """``sink`` needs a ``write(snapshot_dict)`` method."""
        self._sinks.append(sink)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "TelemetryMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="telemetry-sampler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        for sink in self._sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # pragma: no cover - sampler must not die
                import traceback
                traceback.print_exc()

    # -- one tick --------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> dict:
        """One evaluation tick; returns (and streams) the full snapshot."""
        now = time.perf_counter() if now is None else now
        active: dict = {}
        self._poll_schedulers(now, active)
        self._poll_shells(now)
        self._poll_clusters(now)
        self._detect_convoy(now, active)
        self._detect_preempt_regression(now, active)
        self._eval_slos(now, active)
        self._reconcile_alerts(active, now)
        with self._lock:
            self.n_samples += 1
        snap = self.registry.snapshot()
        snap["alerts"] = self.alerts()
        snap["detectors"] = self.detector_state()
        snap["slo"] = self.slo_state()
        for sink in self._sinks:
            sink.write(snap)
        return snap

    # -- gauge polling ---------------------------------------------------

    def _poll_schedulers(self, now: float, active: dict):
        reg = self.registry
        worst = {"wait_s": 0.0, "tenant": None, "priority": None,
                 "bound_s": None}
        for sched, labels in self._scheds:
            try:
                pending = sched.policy.pending_tasks()
            except Exception:
                continue
            per_prio: dict = {}
            per_tenant: dict = {}
            for t in pending:
                if t.t_arrived is None:
                    continue
                wait = max(now - t.t_arrived, 0.0)
                per_prio[t.priority] = max(per_prio.get(t.priority, 0.0),
                                           wait)
                per_tenant[t.tenant] = max(per_tenant.get(t.tenant, 0.0),
                                           wait)
            reg.gauge("queue_depth", **labels).set(len(pending))
            for p, w in per_prio.items():
                reg.gauge("queue_wait_max_seconds", priority=p,
                          **labels).set(w)
            for tn, w in per_tenant.items():
                reg.gauge("queue_wait_max_seconds", tenant=tn,
                          **labels).set(w)
            bound = getattr(getattr(sched, "cfg", None),
                            "starvation_bound_s", None)
            if bound is None:
                bound = self.detectors.starvation_bound_s
            if bound is None:
                continue
            for t in pending:
                if t.t_arrived is None:
                    continue
                wait = now - t.t_arrived
                if wait > bound:
                    key = ("starvation", t.tenant, t.priority)
                    if wait > worst["wait_s"]:
                        worst.update(wait_s=wait, tenant=t.tenant,
                                     priority=t.priority, bound_s=bound)
                    active[key] = {
                        "name": "starvation", "severity": "page",
                        "labels": {"tenant": t.tenant,
                                   "priority": t.priority, **labels},
                        "value": wait, "threshold": bound,
                        "message": (f"task #{t.tid} (tenant={t.tenant}, "
                                    f"prio={t.priority}) queued "
                                    f"{wait:.3f}s > bound {bound:.3f}s"),
                    }
        self._detector_state["starvation"] = worst

    def _poll_shells(self, now: float):
        reg = self.registry
        for shell, labels in self._shells:
            regions = list(shell.regions)
            reg.gauge("pool_regions", **labels).set(len(regions))
            for r in regions:
                key = (id(shell), r.rid)
                busy = r.stats.busy_s
                prev = self._busy_prev.get(key)
                occ = 0.0
                if prev is not None and now > prev[0]:
                    occ = max(0.0, min(1.0,
                                       (busy - prev[1]) / (now - prev[0])))
                self._busy_prev[key] = (now, busy)
                reg.gauge("region_occupancy", region=r.rid,
                          **labels).set(occ)
                reg.gauge("region_busy", region=r.rid, **labels).set(
                    0.0 if r.current_task is None else 1.0)

    def _poll_clusters(self, now: float):
        reg = self.registry
        for fe, labels in self._clusters:
            for node in getattr(fe, "nodes", ()):
                nl = dict(labels, node=str(node.node_id))
                reg.gauge("node_healthy", **nl).set(
                    1.0 if node.healthy else 0.0)
                t0 = self._node_t0.setdefault(id(node), now)
                busy = sum(r.stats.busy_s
                           for r in node.shell._by_rid.values())
                reg.gauge("node_energy_joules", **nl).set(
                    node.power.energy_j(max(now - t0, 0.0), busy))
                reg.gauge("node_idle_watts", **nl).set(node.power.idle_w)

    # -- detectors -------------------------------------------------------

    def _slowdown_series(self):
        for kind, name, labels, inst in self.registry.series():
            if kind == "histogram" and name == "task_slowdown_ratio":
                yield labels, inst

    def _detect_convoy(self, now: float, active: dict):
        cfg = self.detectors
        state = {"worst_p99": 0.0, "size_class": None, "n": 0,
                 "threshold": cfg.convoy_slowdown}
        if cfg.convoy_slowdown is not None:
            for labels, hist in self._slowdown_series():
                xs = hist.window(now, cfg.convoy_window_s)
                if len(xs) < cfg.convoy_min_tasks:
                    continue
                p99 = _pctl(xs, 0.99)
                sc = labels.get("size_class", "?")
                if p99 > state["worst_p99"]:
                    state.update(worst_p99=p99, size_class=sc, n=len(xs))
                if p99 >= cfg.convoy_slowdown:
                    active[("convoy", sc)] = {
                        "name": "convoy", "severity": "warn",
                        "labels": {"size_class": sc},
                        "value": p99, "threshold": cfg.convoy_slowdown,
                        "message": (f"{sc} tasks see p99 slowdown "
                                    f"{p99:.1f}x >= "
                                    f"{cfg.convoy_slowdown:.1f}x over "
                                    f"{len(xs)} tasks (FIFO convoy)"),
                    }
        self._detector_state["convoy"] = state

    def _detect_preempt_regression(self, now: float, active: dict):
        cfg = self.detectors
        state = {"p99_s": 0.0, "n": 0,
                 "target_s": cfg.preempt_response_target_s}
        if cfg.preempt_response_target_s is not None:
            for kind, name, labels, inst in self.registry.series():
                if kind != "histogram" or name != "preempt_response_seconds":
                    continue
                xs = inst.window(now, cfg.preempt_window_s)
                if len(xs) < cfg.preempt_min_samples:
                    continue
                p99 = _pctl(xs, 0.99)
                state.update(p99_s=max(state["p99_s"], p99),
                             n=state["n"] + len(xs))
                if p99 > cfg.preempt_response_target_s:
                    target_ms = cfg.preempt_response_target_s * 1e3
                    active[("preempt_response", str(labels))] = {
                        "name": "preempt_response", "severity": "page",
                        "labels": labels,
                        "value": p99,
                        "threshold": cfg.preempt_response_target_s,
                        "message": (f"preempt response p99 {p99 * 1e3:.1f}ms"
                                    f" > target {target_ms:.1f}ms"),
                    }
        self._detector_state["preempt_response"] = state

    # -- SLO burn rates --------------------------------------------------

    def _burn(self, hist, now: float, window_s: float,
              target_s: float, budget: float):
        xs = hist.window(now, window_s)
        if not xs:
            return None, 0
        bad = sum(1 for v in xs if v > target_s) / len(xs)
        return bad / budget, len(xs)

    def _eval_slos(self, now: float, active: dict):
        state: dict = {}
        series = self.registry.series()
        for pol in self.policies:
            for metric, target in (("task_turnaround_seconds",
                                    pol.latency_target_s),
                                   ("serving_ttft_seconds",
                                    pol.ttft_target_s)):
                if target is None:
                    continue
                for kind, name, labels, inst in series:
                    if kind != "histogram" or name != metric:
                        continue
                    tenant = labels.get("tenant", "default")
                    if pol.tenant != "*" and tenant != pol.tenant:
                        continue
                    short, n_s = self._burn(inst, now, pol.short_window_s,
                                            target, pol.miss_budget)
                    long_, n_l = self._burn(inst, now, pol.long_window_s,
                                            target, pol.miss_budget)
                    st = state.setdefault(tenant, {})
                    st[metric] = {"burn_short": short or 0.0,
                                  "burn_long": long_ or 0.0,
                                  "n_short": n_s, "n_long": n_l,
                                  "target_s": target,
                                  "budget": pol.miss_budget}
                    if (short is not None and long_ is not None
                            and short >= pol.burn_threshold
                            and long_ >= pol.burn_threshold):
                        active[("slo_burn", tenant, metric)] = {
                            "name": "slo_burn", "severity": "page",
                            "labels": {"tenant": tenant, "metric": metric},
                            "value": short,
                            "threshold": pol.burn_threshold,
                            "message": (f"tenant {tenant} burns "
                                        f"{metric} budget at "
                                        f"{short:.1f}x/" f"{long_:.1f}x "
                                        f"(short/long windows) >= "
                                        f"{pol.burn_threshold:.1f}x"),
                        }
        self._slo_state = state

    # -- alert state machine ---------------------------------------------

    def _reconcile_alerts(self, active: dict, now: float):
        with self._lock:
            for key, alert in active.items():
                cur = self._firing.get(key)
                if cur is None:
                    alert["since_s"] = now - self.registry.t0
                    self.n_fired += 1
                else:
                    alert["since_s"] = cur["since_s"]
                self._firing[key] = alert
            for key in [k for k in self._firing if k not in active]:
                gone = self._firing.pop(key)
                gone["resolved_s"] = now - self.registry.t0
                self._resolved.append(gone)

    def alerts(self) -> "list[dict]":
        """Currently-firing alerts, most severe first."""
        with self._lock:
            out = [dict(a) for a in self._firing.values()]
        sev = {"page": 0, "warn": 1}
        return sorted(out, key=lambda a: (sev.get(a["severity"], 2),
                                          a["name"]))

    def resolved(self) -> "list[dict]":
        with self._lock:
            return [dict(a) for a in self._resolved]

    def detector_state(self) -> dict:
        return {k: dict(v) for k, v in self._detector_state.items()}

    def slo_state(self) -> dict:
        return {t: {m: dict(v) for m, v in ms.items()}
                for t, ms in self._slo_state.items()}


# -- report() integration --------------------------------------------------

def telemetry_section(registry: Optional[MetricsRegistry]) -> dict:
    """The ``telemetry`` section of a layer report (always present):
    ``{"enabled": False}`` when no registry is threaded, else series
    counts plus the monitor's alert/detector/SLO state."""
    if registry is None:
        return {"enabled": False}
    out = {"enabled": True, "n_series": registry.n_series()}
    mon = getattr(registry, "monitor", None)
    if mon is None:
        out.update(sampler=False, alerts=[], alerts_fired_total=0,
                   detectors={}, slo={}, samples=0)
    else:
        out.update(sampler=True, alerts=mon.alerts(),
                   alerts_fired_total=mon.n_fired,
                   detectors=mon.detector_state(), slo=mon.slo_state(),
                   samples=mon.n_samples)
    return out
