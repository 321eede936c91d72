"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over the
measured window, read back from its Chrome trace.

The window is the host range annotated ``WINDOW``; every interval is
clipped to it.  Busy time is the union of the card's kernel, copy and
memset intervals (a copy of ``chip_smoke.py``'s ``_busy_share``).  An idle
gap is named by what the host was doing at its midpoint: the innermost CUDA
runtime call or operator, else the program's own innermost span (its flight
recorder, on the host clock), else ``host: none``.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "perfbench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")


def merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class DeviceEvent:
    cat: str
    name: str
    start_us: float
    end_us: float

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


@dataclass
class DeviceTrace:
    lo_us: float
    hi_us: float
    device: List[DeviceEvent]
    host: List[DeviceEvent] = field(repr=False, default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.hi_us - self.lo_us) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(
            (e.start_us, e.end_us) for e in self.device)) / 1e6

    def kernels(self, name_part: str) -> List[DeviceEvent]:
        return [e for e in self.device
                if e.cat == "kernel" and name_part in e.name]

    def copies(self, direction: str) -> List[DeviceEvent]:
        """Copies whose name holds ``direction`` (``HtoD``, ``DtoH``...)."""
        return [e for e in self.device
                if e.cat == "gpu_memcpy" and direction in e.name]

    def by_name(self) -> Dict[str, float]:
        """Device seconds by kernel, copy or memset name."""
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            out[e.name] += e.dur_us / 1e6
        return dict(out)

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window, in microseconds."""
        busy = merged((e.start_us, e.end_us) for e in self.device)
        out, t = [], self.lo_us
        for a, b in busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi_us > t:
            out.append((t, self.hi_us))
        return out

    def idle_by_host(self, spans: Sequence[Tuple[str, float, float]] = (),
                     top: int = 10) -> List[List]:
        """Idle seconds by what the host was doing, largest first: over each
        gap's midpoint, the innermost host call (the latest started of those
        running), else the program's innermost span.  ``spans`` are the
        program's own (name, start, end) in this trace's microseconds."""
        host = sorted(((e.start_us, e.end_us, f"{e.cat}: {e.name}")
                       for e in self.host))
        progs = sorted((s, t, f"program: {n}") for n, s, t in spans)
        gaps = sorted(((a + b) / 2, b - a) for a, b in self.gaps())
        out: Dict[str, float] = defaultdict(float)
        for (mid, dur), h, p in zip(gaps, _covering(gaps, host),
                                    _covering(gaps, progs)):
            out[h or p or "host: none"] += dur / 1e6
        return [[k, v] for k, v in
                sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def _covering(points, intervals) -> List[Optional[str]]:
    """For each (t, _) of ``points`` (sorted), the name of the latest
    started of the (start, end, name) ``intervals`` (sorted) that covers t."""
    out, active, i = [], [], 0
    for t, _ in points:
        while i < len(intervals) and intervals[i][0] <= t:
            active.append(intervals[i])
            i += 1
        active = [iv for iv in active if iv[1] > t]
        out.append(active[-1][2] if active else None)
    return out


def read_chrome_trace(path: str) -> Optional[DeviceTrace]:
    """The trace's window and its device and host events, clipped; None if
    the window annotation is missing."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next((e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        return None
    lo, hi = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    dev, host = [], []
    for e in events:
        cat = e.get("cat")
        if "dur" not in e or (cat not in DEVICE_CATS and cat not in HOST_CATS):
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
        if b <= a:
            continue
        ev = DeviceEvent(cat, str(e.get("name", "")), a, b)
        (dev if cat in DEVICE_CATS else host).append(ev)
    return DeviceTrace(lo, hi, dev, host)
