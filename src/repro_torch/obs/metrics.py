"""Derived latency metrics over a raw trace-event stream.

Folds the flight recorder's event stream into the numbers the paper's
claims are actually about:

- **per-task latency breakdown** — queue_wait / reconfig_wait / run /
  preempted / migrating / turnaround, aggregated to percentiles across
  tasks (plus a bounded per-task detail map);
- **preemption response latency** — ``preempt_request`` → the matching
  ``preempt_honored`` on the same region track (for the megakernel this
  is exactly the request → flag-poll-exit distance);
- **region occupancy / idle-gap histograms** — busy fraction per region
  and the distribution of gaps between busy spans;
- **ICAP serialization** — total lock hold and acquire-wait time, the
  paper's single shared reconfiguration port made visible.

``trace_section(tracer)`` wraps this for ``report()``: every layer report
always carries a ``trace`` key — ``{"enabled": False}`` when no tracer is
threaded, the derived dict when one is.

A copy of the reference's ``repro.obs.metrics``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

from repro_torch.obs.tracer import TraceEvent, Tracer

# Phase keys of the per-task breakdown, in presentation order.
PHASES = ("queue_wait_s", "reconfig_wait_s", "run_s", "preempted_s",
          "migrating_s", "turnaround_s")

# Idle-gap histogram bucket upper bounds (seconds); last bucket is open.
_GAP_EDGES = (1e-3, 1e-2, 1e-1)
_GAP_LABELS = ("lt_1ms", "lt_10ms", "lt_100ms", "ge_100ms")

_MAX_TASK_DETAIL = 32  # bound report size; aggregates cover the rest


def _percentiles(xs: "list[float]") -> dict:
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    s = sorted(xs)
    n = len(s)

    def pct(q):
        return s[min(n - 1, max(0, int(math.ceil(q / 100.0 * n)) - 1))]

    return {"n": n, "mean": sum(s) / n, "p50": pct(50), "p99": pct(99),
            "max": s[-1]}


def derive_metrics(events: Iterable[TraceEvent]) -> dict:
    evs = sorted(events, key=lambda e: e.t)
    kinds: dict = {}
    for e in evs:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1

    window_t0 = evs[0].t if evs else 0.0
    window_t1 = max((e.t + e.dur for e in evs), default=0.0)
    window = max(window_t1 - window_t0, 0.0)

    return {
        "n_events": len(evs),
        "kinds": kinds,
        "window_s": window,
        "per_task": _per_task(evs),
        "preempt_response": _preempt_response(evs),
        "regions": _region_occupancy(evs, window_t0, window_t1),
        "icap": _icap(evs),
        "compile": _compile(evs),
    }


# -- per-task breakdown ----------------------------------------------------

def _per_task(evs: "list[TraceEvent]") -> dict:
    submit: dict = {}
    dispatches: dict = {}
    honored: dict = {}
    done: dict = {}
    sums: dict = {}  # tid -> {phase: s}

    def bucket(tid):
        return sums.setdefault(tid, {p: 0.0 for p in PHASES})

    for e in evs:
        tid = e.tid
        if tid is None:
            continue
        if e.kind in ("submit", "seq_submit"):
            submit.setdefault(tid, e.t)
        elif e.kind in ("dispatch", "prefill_dispatch"):
            dispatches.setdefault(tid, []).append(e.t)
        elif e.kind == "preempt_honored":
            honored.setdefault(tid, []).append(e.t)
        elif e.kind in ("done", "ttft"):
            done.setdefault(tid, e.t)
        elif e.kind == "run":
            bucket(tid)["run_s"] += e.dur
        elif e.kind == "reconfig":
            bucket(tid)["reconfig_wait_s"] += e.dur
        elif e.kind == "migrate":
            bucket(tid)["migrating_s"] += e.dur

    tids = sorted(t for t in dispatches if t in submit)
    for tid in tids:
        b = bucket(tid)
        ds = sorted(dispatches[tid])
        b["queue_wait_s"] = max(ds[0] - submit[tid], 0.0)
        for h in honored.get(tid, ()):  # preempted: honored -> re-dispatch
            nxt = next((d for d in ds if d > h), None)
            if nxt is not None:
                b["preempted_s"] += nxt - h
        if tid in done:
            b["turnaround_s"] = max(done[tid] - submit[tid], 0.0)

    agg = {p: _percentiles([sums[t][p] for t in tids]) for p in PHASES}
    detail = {str(t): {p: sums[t][p] for p in PHASES}
              for t in tids[:_MAX_TASK_DETAIL]}
    return {"n_tasks": len(tids), "phases": agg, "tasks": detail,
            "tasks_truncated": len(tids) > _MAX_TASK_DETAIL}


# -- preemption response ---------------------------------------------------

def _preempt_response(evs: "list[TraceEvent]") -> dict:
    """Pair each region's earliest outstanding request with the next honor.

    ``request_preempt`` is idempotent per region (the scheduler guards
    with ``_preempt_pending``), but probes may still re-request: latency
    is measured from the *first* unhonored request, which is what a
    waiting scheduler actually experiences.
    """
    pending: dict = {}
    samples: "list[float]" = []
    for e in evs:
        if e.track and e.track[0] != "region":
            continue
        if e.kind == "preempt_request":
            pending.setdefault(e.track, e.t)
        elif e.kind == "preempt_honored":
            t_req = pending.pop(e.track, None)
            if t_req is not None:
                samples.append(max(e.t - t_req, 0.0))
        elif e.kind == "done":
            # Task finished before honoring: the request is moot
            # (region.cancel_preempt path); drop it so the next round's
            # pairing doesn't straddle an idle period.
            pending.pop(e.track, None)
    stats = _percentiles(samples)
    return {"n": stats["n"], "mean_s": stats["mean"], "p50_s": stats["p50"],
            "p99_s": stats["p99"], "max_s": stats["max"],
            "unmatched_requests": len(pending)}


# -- region occupancy ------------------------------------------------------

def _region_occupancy(evs, t0: float, t1: float) -> dict:
    spans: dict = {}  # rid -> list of (start, end)
    for e in evs:
        if e.track and e.track[0] == "region" and e.dur > 0.0 \
                and e.kind in ("run", "reconfig"):
            spans.setdefault(e.track[1], []).append((e.t, e.t + e.dur))

    window = max(t1 - t0, 0.0)
    out = {}
    for rid, ss in sorted(spans.items()):
        merged = []
        for s, e in sorted(ss):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        busy = sum(e - s for s, e in merged)
        gaps = [b[0] - a[1] for a, b in zip(merged, merged[1:])
                if b[0] > a[1]]
        hist = dict.fromkeys(_GAP_LABELS, 0)
        for g in gaps:
            for edge, label in zip(_GAP_EDGES, _GAP_LABELS):
                if g < edge:
                    hist[label] += 1
                    break
            else:
                hist[_GAP_LABELS[-1]] += 1
        out[str(rid)] = {
            "busy_s": busy,
            "occupancy": (busy / window) if window > 0 else 0.0,
            "idle_gaps": hist,
            "longest_idle_gap_s": max(gaps, default=0.0),
        }
    return out


# -- ICAP / compile --------------------------------------------------------

def _icap(evs) -> dict:
    holds = [e for e in evs if e.kind == "icap"]
    return {
        "holds": len(holds),
        "hold_s": sum(e.dur for e in holds),
        "wait_s": sum((e.attrs or {}).get("wait_s", 0.0) for e in holds),
    }


def _compile(evs) -> dict:
    cs = [e for e in evs if e.kind == "compile"]
    return {"n": len(cs), "total_s": sum(e.dur for e in cs)}


# -- report() integration --------------------------------------------------

def trace_section(tracer: Optional[Tracer]) -> dict:
    """The ``trace`` section of a layer report (always present)."""
    if tracer is None:
        return {"enabled": False}
    out = {"enabled": True, "capacity": tracer.capacity,
           "emitted": tracer.n_emitted, "dropped": tracer.dropped}
    out.update(derive_metrics(tracer.events()))
    return out
