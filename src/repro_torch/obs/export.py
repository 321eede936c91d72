"""Chrome-trace-event (Perfetto-loadable) JSON export.

Track layout (DESIGN.md §11): each track *type* becomes a Chrome trace
"process" and each instance a "thread" within it, so ui.perfetto.dev
renders one labelled row per region, per ICAP port, per shell/node, per
serving slot, etc.  Spans (``dur > 0``) export as ``"X"`` complete events
and instants as ``"i"`` with thread scope; timestamps are microseconds
relative to the tracer's ``t0``.

A copy of the reference's ``repro.obs.export``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional, Union

from repro_torch.obs.tracer import TraceEvent, Tracer

# Stable process ordering so the Perfetto UI groups rows the same way on
# every run; unknown track types sort after these, alphabetically.
_TRACK_ORDER = ["sched", "region", "icap", "compile", "pool", "cluster",
                "node", "serving", "slot", "lm"]
_TRACK_LABEL = {
    "sched": "scheduler",
    "region": "regions",
    "icap": "ICAP ports",
    "compile": "bitstream compiles",
    "pool": "region pool",
    "cluster": "cluster frontend",
    "node": "cluster nodes",
    "serving": "serving engine",
    "slot": "serving slots",
    "lm": "lm pipeline",
}


def _track_key(track_type: str) -> tuple:
    try:
        return (0, _TRACK_ORDER.index(track_type))
    except ValueError:
        return (1, track_type)


def export_chrome_trace(source: Union[Tracer, Iterable[TraceEvent]],
                        path: Optional[str] = None,
                        t0: Optional[float] = None) -> dict:
    """Render events as a Chrome trace dict; optionally write it to ``path``.

    ``source`` is a :class:`Tracer` (preferred — carries ``t0`` and drop
    accounting) or a bare event iterable (then pass ``t0`` or the earliest
    event time is used).
    """
    if isinstance(source, Tracer):
        events = source.events()
        base = source.t0 if t0 is None else t0
        other = {"tracer_capacity": source.capacity,
                 "events_emitted": source.n_emitted,
                 "events_dropped": source.dropped,
                 # alias: the name trace consumers (tools/trace_report.py,
                 # CI) look for when auditing ring truncation
                 "dropped_events": source.dropped}
    else:
        events = list(source)
        base = t0 if t0 is not None else min((e.t for e in events),
                                             default=0.0)
        other = {}

    tracks = sorted({e.track for e in events}, key=_instance_key)
    pid_of = {}
    for tr in tracks:
        pid_of.setdefault(str(tr[0]), len(pid_of) + 1)
    tid_of = _assign_tids(tracks)

    out = []
    for ttype in sorted(pid_of, key=_track_key):
        pid = pid_of[ttype]
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": _TRACK_LABEL.get(ttype, ttype)}})
    for tr in tracks:
        ttype = str(tr[0])
        inst = tr[1] if len(tr) > 1 else 0
        out.append({"ph": "M", "name": "thread_name",
                    "pid": pid_of[ttype], "tid": tid_of[tr],
                    "args": {"name": f"{ttype} {inst}"}})

    for e in events:
        args = dict(e.attrs) if e.attrs else {}
        if e.tid is not None:
            args["task"] = e.tid
        rec = {"name": e.kind, "cat": str(e.track[0]),
               "pid": pid_of[str(e.track[0])], "tid": tid_of[e.track],
               "ts": (e.t - base) * 1e6}
        if args:
            rec["args"] = args
        if e.dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = e.dur * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)

    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    if other:
        doc["otherData"] = other
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def _instance_key(track: tuple) -> tuple:
    """Total order over tracks even when instance ids mix ints and strings
    within one track type (ints first, numerically; then strings)."""
    return (_track_key(str(track[0])),
            [(1, 0, str(i)) if isinstance(i, bool) or not isinstance(i, int)
             else (0, i, "") for i in track[1:]])


def _assign_tids(tracks: "list[tuple]") -> dict:
    """Unique Chrome tid per track instance within its pid.

    Int instances keep their value (region 3 renders as tid 3); everything
    else (e.g. node-name strings) takes the next free counter value within
    the pid, so distinct instances can never merge into one Perfetto row.
    """
    tid_of, used = {}, {}
    for tr in tracks:
        inst = tr[1] if len(tr) > 1 else 0
        if isinstance(inst, int) and not isinstance(inst, bool):
            tid_of[tr] = inst
            used.setdefault(str(tr[0]), set()).add(inst)
    for tr in tracks:
        if tr in tid_of:
            continue
        taken = used.setdefault(str(tr[0]), set())
        n = 0
        while n in taken:
            n += 1
        taken.add(n)
        tid_of[tr] = n
    return tid_of
