"""Live metrics registry (DESIGN.md §12): counters, gauges, and
bounded-bucket histograms, labeled by shell/region/tenant/phase.

The flight recorder (§11) answers *where a past run spent its time*; this
registry answers *what the server looks like right now*.  Design rules
mirror the tracer's:

- **Zero cost when disabled.**  Layers hold an ``Optional[MetricsRegistry]``
  and guard every update with ``if m is not None`` — the disabled path is
  one attribute read plus a None check.
- **Lock-cheap when enabled.**  Instrument lookup is a dict read (taken
  under the registry lock only on first creation of a series); an update
  is one arithmetic op under the instrument's own uncontended lock.
  Updates arrive from region worker threads, the scheduler loop, the
  sampler thread, and HTTP scrape threads concurrently.
- **Bounded.**  Histograms hold a fixed bucket vector plus a bounded
  ``recent`` deque of (t, value) samples for windowed SLO math
  (``obs/slo.py``); nothing in the registry grows with run length.
- **Monotonic clock.**  Sample timestamps are ``time.perf_counter()``,
  the same clock as the tracer and every ``report()`` wall.

Label sets are passed as keyword arguments and identify the series:
``reg.counter("tasks_done_total", tenant="bg").inc()``.  A (name, labels)
pair always resolves to the same instrument object, so hot paths may also
cache the handle themselves.

A copy of the reference's ``repro.obs.registry``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

# Default latency buckets (seconds): log-spaced from 100us to 60s, wide
# enough for chunk latencies and whole-run turnarounds alike.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Ratio buckets for dimensionless distributions (slowdown, burn rate).
RATIO_BUCKETS = (1.0, 1.5, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 50.0, 100.0)

# Bounded per-histogram sample memory for windowed detector/SLO math.
RECENT_SAMPLES = 512


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Gauge:
    """Point-in-time value (set wins; inc/dec for running levels)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self.value -= v


class Histogram:
    """Fixed-bucket distribution with p50/p99 estimation.

    Percentiles are interpolated from the bucket counts (Prometheus
    ``histogram_quantile`` semantics); the open top bucket is capped at
    the observed max so a single outlier cannot report +inf.  A bounded
    ``recent`` deque of (perf_counter, value) pairs backs the windowed
    SLO/burn-rate math in ``obs/slo.py``.
    """

    __slots__ = ("_lock", "bounds", "counts", "sum", "n", "max", "recent")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.bounds) + 1)  # +1: open top bucket
        self.sum = 0.0
        self.n = 0
        self.max = 0.0
        self.recent: deque = deque(maxlen=RECENT_SAMPLES)

    def observe(self, v: float, t: Optional[float] = None) -> None:
        ts = t if t is not None else time.perf_counter()
        with self._lock:
            self.counts[bisect.bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.n += 1
            if v > self.max:
                self.max = v
            self.recent.append((ts, v))

    def percentile(self, q: float) -> float:
        """Estimate the ``q`` (0..1) percentile from bucket counts."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        target = q * self.n
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                hi = max(hi, lo)
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.max

    def window(self, now: float, window_s: float) -> "list[float]":
        """Values observed within the trailing ``window_s`` seconds."""
        cutoff = now - window_s
        with self._lock:
            return [v for (t, v) in self.recent if t >= cutoff]

    def summary(self) -> dict:
        with self._lock:
            return {
                "count": self.n,
                "sum": self.sum,
                "mean": (self.sum / self.n) if self.n else 0.0,
                "p50": self._percentile_locked(0.50),
                "p99": self._percentile_locked(0.99),
                "max": self.max,
            }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Labeled instrument store shared by every layer of one deployment.

    Threaded exactly like the tracer: ``Shell(metrics=...)`` /
    ``ClusterFrontend(metrics=...)`` fan the handle out, downstream layers
    adopt it with ``getattr(obj, "metrics", None)``.  A
    :class:`~repro_torch.obs.slo.TelemetryMonitor` attaches itself as
    ``registry.monitor`` so report sections and sinks can reach alert
    state through the registry alone.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (kind, name, label_key) -> instrument
        self._series: Dict[tuple, object] = {}
        self.t0 = time.perf_counter()
        self.monitor = None  # set by TelemetryMonitor.__init__

    # -- instrument accessors (create-on-first-use) ---------------------

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        factory = (lambda: Histogram(buckets)) if buckets is not None \
            else Histogram
        return self._get("histogram", name, labels, factory)

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, name, _label_key(labels))
        inst = self._series.get(key)
        if inst is None:
            with self._lock:
                inst = self._series.get(key)
                if inst is None:
                    inst = self._series[key] = factory()
        return inst

    # -- introspection ---------------------------------------------------

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    def series(self) -> "list[tuple]":
        """Stable snapshot: (kind, name, labels_dict, instrument)."""
        with self._lock:
            items = list(self._series.items())
        return [(kind, name, dict(lk), inst)
                for (kind, name, lk), inst in sorted(
                    items, key=lambda kv: kv[0])]

    def snapshot(self) -> dict:
        """Plain-dict view of every series (JSONL sink / top.py / tests)."""
        out = {"uptime_s": time.perf_counter() - self.t0,
               "n_series": 0, "counters": {}, "gauges": {},
               "histograms": {}}
        for kind, name, labels, inst in self.series():
            out["n_series"] += 1
            if kind == "counter":
                out["counters"].setdefault(name, []).append(
                    {"labels": labels, "value": inst.value})
            elif kind == "gauge":
                out["gauges"].setdefault(name, []).append(
                    {"labels": labels, "value": inst.value})
            else:
                out["histograms"].setdefault(name, []).append(
                    {"labels": labels, **inst.summary()})
        return out
