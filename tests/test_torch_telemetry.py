"""The port's live telemetry (``repro_torch.obs``: registry, exporter, SLO
monitor and detectors) against the reference's ``repro.obs``, and the twins
of ``tests/test_telemetry.py``, run on ``devices=["cpu"]``.

- **Bitwise parity.**  The same registry operations, made from a numpy seed
  (labels that need escaping, custom bucket sets, histogram windows, an
  explicit ``t=``), applied to a registry of each package under one frozen
  clock, must give equal Prometheus text, snapshots, telemetry documents
  and JSONL lines.  Two monitors driven tick by tick with ``sample(now=...)``
  over the same scripted queues, histograms and region busy times must fire
  and resolve every detector (starvation, convoy, preemption-response
  regression) and the SLO burn alert in the same ticks, with equal alert
  dicts and equal snapshots.
- **Live runs.**  ``Client(metrics=reg, device="cpu")`` scrapes as
  Prometheus text mid-run; ``Client(tracer=, metrics=, serving={"lm":
  "attention"})`` streams the oracle's tokens with the serving counters,
  the TTFT histogram and the ``decode_round`` spans matching the engine.
- ``tools/top.py`` reads the port's JSONL stream unchanged.
"""
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

from repro import obs as R_obs  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.core.policy import (EarliestDeadlineFirst,  # noqa: E402
                                     FcfsPriority, WeightedFairShare)
from repro_torch.core.task import Task, TaskStatus  # noqa: E402
from repro_torch.obs import (DetectorConfig, JsonlMetricsWriter,  # noqa: E402
                             MetricsHTTPServer, MetricsRegistry, SloPolicy,
                             TelemetryMonitor, prometheus_text,
                             telemetry_json, telemetry_section)

REPO = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2)
CLOCK = 5000.0       # the frozen perf_counter of the parity tests
TIMEOUT = 120


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages read ``time.perf_counter`` for registry ``t0``,
    ``uptime_s`` and default sample times: freeze it, so the only clock
    in a parity test is the one the test passes explicitly."""
    monkeypatch.setattr(time, "perf_counter", lambda: CLOCK)


# -- registry operations, bitwise ---------------------------------------------

_LABEL_VALUES = ('a"b\\c', "x y", "t0", "ü", "", "1.5")


def _registry_ops(seed):
    """A list of (op, name, labels, args) made from ``seed``."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        which = int(rng.integers(0, 5))
        name = ("tasks_done_total", "queue-depth", "lat", "ratio",
                "weird.name")[int(rng.integers(0, 5))]
        labels = {}
        for key in ("tenant", "region", "path")[:int(rng.integers(0, 4))]:
            labels[key] = _LABEL_VALUES[int(rng.integers(0, 6))]
        if which == 0:
            ops.append(("counter", "c_" + name, labels,
                        float(rng.integers(1, 4))))
        elif which == 1:
            ops.append(("gauge_set", "g_" + name, labels,
                        float(rng.normal()) * 10))
        elif which == 2:
            ops.append(("gauge_inc", "g_" + name, labels,
                        float(rng.random())))
        else:
            buckets = ("default", "custom", "ratio")[int(rng.integers(0, 3))]
            ops.append(("observe", f"h_{buckets}_{name}", labels,
                        (buckets, float(rng.exponential(0.2)),
                         CLOCK - float(rng.uniform(0, 60)))))
    return ops


def _apply(obs, ops):
    reg = obs.MetricsRegistry()
    buckets_of = {"default": None, "custom": (0.001, 0.01, 0.1, 1.0),
                  "ratio": obs.registry.RATIO_BUCKETS}
    for op, name, labels, arg in ops:
        if op == "counter":
            reg.counter(name, **labels).inc(arg)
        elif op == "gauge_set":
            reg.gauge(name, **labels).set(arg)
        elif op == "gauge_inc":
            reg.gauge(name, **labels).inc(arg)
            reg.gauge(name, **labels).dec(arg / 3)
        else:
            buckets, v, t = arg
            reg.histogram(name, buckets=buckets_of[buckets],
                          **labels).observe(v, t=t)
    return reg


def _hist_view(reg):
    out = []
    for kind, name, labels, inst in reg.series():
        if kind == "histogram":
            out.append((name, labels, [inst.percentile(q) for q in
                                       (0.0, 0.5, 0.9, 0.99, 1.0)],
                        inst.window(CLOCK, 10.0), inst.window(CLOCK, 45.0),
                        inst.summary()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("view", ["prometheus", "snapshot", "telemetry",
                                  "histograms", "jsonl"])
def test_registry_equals_reference(view, seed, frozen_clock, tmp_path):
    ops = _registry_ops(seed)
    ref = _apply(R_obs, ops)
    port = _apply(P_obs, ops)
    assert port.n_series() == ref.n_series() > 10
    if view == "prometheus":
        got, want = P_obs.prometheus_text(port), R_obs.prometheus_text(ref)
        assert got == want
        assert '\\"' in got and "\\\\" in got     # escaping exercised
    elif view == "snapshot":
        assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    elif view == "telemetry":
        P_obs.TelemetryMonitor(port).sample(now=CLOCK)
        R_obs.TelemetryMonitor(ref).sample(now=CLOCK)
        assert json.dumps(P_obs.telemetry_json(port)) == \
            json.dumps(R_obs.telemetry_json(ref))
        assert P_obs.telemetry_section(port) == \
            R_obs.telemetry_section(ref)
    elif view == "histograms":
        assert _hist_view(port) == _hist_view(ref)
    else:
        lines = {}
        for side, obs, reg in (("port", P_obs, port), ("ref", R_obs, ref)):
            path = tmp_path / f"{side}.jsonl"
            mon = obs.TelemetryMonitor(reg)
            mon.add_sink(obs.JsonlMetricsWriter(str(path)))
            for k in range(3):
                mon.sample(now=CLOCK + k)
            mon.stop()
            lines[side] = path.read_text()
        assert lines["port"] == lines["ref"]
        assert len(lines["port"].splitlines()) == 3


# -- detectors and SLO burn, tick by tick -------------------------------------

DETECTORS = dict(starvation_bound_s=5.0, convoy_slowdown=8.0,
                 convoy_min_tasks=6, convoy_window_s=10.0,
                 preempt_response_target_s=0.05, preempt_min_samples=5,
                 preempt_window_s=10.0)
POLICIES = (dict(tenant="acme", latency_target_s=0.1, miss_budget=0.1,
                 short_window_s=3.0, long_window_s=12.0, burn_threshold=2.0),
            dict(tenant="*", ttft_target_s=0.2, miss_budget=0.2,
                 short_window_s=2.0, long_window_s=6.0, burn_threshold=1.5))
N_TICKS = 45


def _scripted_ticks(seed):
    """Per tick: (now, pending [(tid, t_arrived, tenant, priority)],
    observations [(name, labels, value)], region busy seconds)."""
    rng = np.random.default_rng(seed)
    noise = lambda s: float(rng.uniform(0, s))  # noqa: E731
    t0 = CLOCK
    victim = (7, t0 + 2.0 + noise(0.4), "victim", 2)
    ticks, busy = [], [0.0, 0.0]
    for k in range(N_TICKS):
        now = t0 + k
        pending = []
        if 3 <= k < 12:                                # starvation
            pending.append(victim)
        if k % 4 == 0:                                 # young, never starved
            pending.append((100 + k, now - noise(1.0), "bg", 4))
        obs = []
        if 12 <= k < 15:                               # convoy
            obs += [("task_slowdown_ratio", {"size_class": "short"},
                     20.0 + noise(5)) for _ in range(3)]
        obs.append(("task_slowdown_ratio", {"size_class": "long"},
                    1.0 + noise(0.5)))
        if 5 <= k < 8:                                 # preempt regression
            obs += [("preempt_response_seconds", {"region": r},
                     0.2 + noise(0.1)) for r in (0, 0, 1)]
        if k % 3 == 0:
            obs.append(("preempt_response_seconds", {"region": 1},
                        0.001 + noise(0.001)))
        if 20 <= k < 24:                               # turnaround SLO
            obs += [("task_turnaround_seconds", {"tenant": "acme"},
                     v) for v in (0.5, 0.6 + noise(0.1), 0.01)]
        obs.append(("task_turnaround_seconds", {"tenant": "acme"},
                    0.01 + noise(0.01)))
        if 30 <= k < 33:                               # TTFT SLO, any tenant
            obs += [("serving_ttft_seconds", {"tenant": "chat"},
                     0.9 + noise(0.2)) for _ in range(2)]
        if k % 2:
            obs.append(("serving_ttft_seconds", {"tenant": "chat"},
                        0.05 + noise(0.05)))
        busy = [b + noise(1.0) for b in busy]
        ticks.append((now, pending, obs, list(busy)))
    return ticks


def _drive(obs, ticks, path):
    reg = obs.MetricsRegistry()
    mon = obs.TelemetryMonitor(
        reg, policies=[obs.SloPolicy(**p) for p in POLICIES],
        detectors=obs.DetectorConfig(**DETECTORS))
    state = {"pending": []}
    regions = [SimpleNamespace(rid=r, stats=SimpleNamespace(busy_s=0.0),
                               current_task=None) for r in (0, 1)]
    sched = SimpleNamespace(
        policy=SimpleNamespace(pending_tasks=lambda: state["pending"]),
        cfg=SimpleNamespace(starvation_bound_s=None),
        shell=SimpleNamespace(regions=regions))
    mon.attach(scheduler=sched, shell_label="s0")
    mon.add_sink(obs.JsonlMetricsWriter(str(path)))
    out = []
    for now, pending, observations, busy in ticks:
        state["pending"] = [SimpleNamespace(tid=tid, t_arrived=ta,
                                            tenant=tn, priority=p)
                            for tid, ta, tn, p in pending]
        for r, b in zip(regions, busy):
            r.stats.busy_s = b
            r.current_task = object() if b > 10 else None
        for name, labels, v in observations:
            kw = ({"buckets": obs.registry.RATIO_BUCKETS}
                  if name == "task_slowdown_ratio" else {})
            reg.histogram(name, **kw, **labels).observe(v, t=now)
        snap = mon.sample(now=now)
        out.append({"snapshot": json.dumps(snap), "alerts": mon.alerts(),
                    "resolved": mon.resolved(), "fired": mon.n_fired,
                    "section": obs.telemetry_section(reg)})
    mon.stop()
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_monitor_ticks_equal_reference(seed, frozen_clock, tmp_path):
    ticks = _scripted_ticks(seed)
    port = _drive(P_obs, ticks, tmp_path / "port.jsonl")
    ref = _drive(R_obs, ticks, tmp_path / "ref.jsonl")
    for k, (got, want) in enumerate(zip(port, ref)):
        assert got == want, f"tick {k}"
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    # every detector and the SLO burn fired and resolved within the script
    fired = {a["name"] for tick in port for a in tick["alerts"]}
    resolved = {a["name"] for a in port[-1]["resolved"]}
    want = {"starvation", "convoy", "preempt_response", "slo_burn"}
    assert want <= fired and want <= resolved
    slo = {a["labels"]["metric"] for a in port[-1]["resolved"]
           if a["name"] == "slo_burn"}
    assert slo == {"task_turnaround_seconds", "serving_ttft_seconds"}
    assert port[-1]["alerts"] == []


# -- registry -----------------------------------------------------------------

def test_counter_gauge_label_identity():
    reg = MetricsRegistry()
    reg.counter("jobs_total", tenant="a").inc()
    reg.counter("jobs_total", tenant="a").inc(2)
    reg.counter("jobs_total", tenant="b").inc()
    assert reg.counter("jobs_total", tenant="a").value == 3.0
    assert reg.counter("jobs_total", tenant="b").value == 1.0
    g = reg.gauge("depth")
    g.set(5)
    g.dec(2)
    assert reg.gauge("depth").value == 3.0
    assert reg.n_series() == 3


def test_histogram_percentiles_and_window():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(0.001, 0.01, 0.1, 1.0))
    now = 100.0
    for _ in range(100):
        h.observe(0.005, t=now - 50.0)
    for _ in range(10):
        h.observe(0.5, t=now - 1.0)
    s = h.summary()
    assert s["count"] == 110
    assert s["max"] == pytest.approx(0.5)
    assert 0.001 <= h.percentile(0.5) <= 0.01
    assert h.percentile(0.99) > 0.1
    recent = h.window(now, 10.0)
    assert len(recent) == 10 and all(v == 0.5 for v in recent)
    h.observe(42.0, t=now)
    assert h.percentile(1.0) <= 42.0


def test_snapshot_shape():
    reg = MetricsRegistry()
    reg.counter("c", x="1").inc()
    reg.gauge("g").set(2)
    reg.histogram("h").observe(0.1)
    snap = reg.snapshot()
    assert snap["n_series"] == 3
    assert snap["counters"]["c"][0] == {"labels": {"x": "1"}, "value": 1.0}
    assert snap["gauges"]["g"][0]["value"] == 2.0
    assert snap["histograms"]["h"][0]["count"] == 1


# -- exporter -----------------------------------------------------------------

def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("tasks_done_total", tenant="a").inc(3)
    reg.gauge("queue_depth").set(2)
    reg.histogram("task_turnaround_seconds",
                  buckets=(0.1, 1.0), tenant="a").observe(0.5)
    txt = prometheus_text(reg)
    assert "# TYPE repro_tasks_done_total counter" in txt
    assert 'repro_tasks_done_total{tenant="a"} 3' in txt
    assert "# TYPE repro_queue_depth gauge" in txt
    assert "# TYPE repro_task_turnaround_seconds histogram" in txt
    assert 'le="0.1"' in txt and 'le="+Inf"' in txt
    assert "repro_task_turnaround_seconds_count" in txt
    lines = [ln for ln in txt.splitlines()
             if ln.startswith("repro_task_turnaround_seconds_bucket")]
    counts = [float(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts), "buckets must be cumulative"


def test_prometheus_label_escaping():
    reg = MetricsRegistry()
    reg.counter("c", path='a"b\\c').inc()
    assert 'path="a\\"b\\\\c"' in prometheus_text(reg)


def test_http_server_scrape_and_json():
    reg = MetricsRegistry()
    reg.counter("hits_total").inc()
    srv = MetricsHTTPServer(reg, port=0)
    try:
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=5) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert "repro_hits_total 1" in body
        with urllib.request.urlopen(f"{srv.url}/telemetry.json",
                                    timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["n_series"] == 1
    finally:
        srv.close()
    srv.close()  # idempotent


def test_jsonl_writer(tmp_path):
    path = tmp_path / "stream.jsonl"
    reg = MetricsRegistry()
    mon = TelemetryMonitor(reg)
    w = JsonlMetricsWriter(str(path))
    mon.add_sink(w)
    mon.sample()
    mon.sample()
    w.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines() if ln]
    assert len(lines) == 2
    assert all("alerts" in ln and "detectors" in ln for ln in lines)


def test_telemetry_json_includes_monitor_state():
    reg = MetricsRegistry()
    TelemetryMonitor(reg).sample()
    doc = telemetry_json(reg)
    assert doc["alerts"] == [] and "detectors" in doc and "slo" in doc


# -- detectors, each alone ----------------------------------------------------

def _stub_sched(pending, bound=None):
    return SimpleNamespace(
        policy=SimpleNamespace(pending_tasks=lambda: pending),
        cfg=SimpleNamespace(starvation_bound_s=bound), shell=None)


def _pending_task(wait_s, now, tenant="default", priority=2, tid=1):
    return SimpleNamespace(t_arrived=now - wait_s, tenant=tenant,
                           priority=priority, tid=tid)


def _only(cfg, feed=lambda reg, now: None, scheds=()):
    """Alert names firing after one sample tick."""
    reg = MetricsRegistry()
    mon = TelemetryMonitor(reg, detectors=cfg)
    now = time.perf_counter()
    for s in scheds:
        mon._scheds.append((s, {}))
    feed(reg, now)
    mon.sample(now=now)
    return mon, sorted({a["name"] for a in mon.alerts()})


def test_starvation_detector_fires_alone():
    cfg = DetectorConfig(starvation_bound_s=1.0, convoy_slowdown=None,
                         preempt_response_target_s=None)
    now = time.perf_counter()
    sched = _stub_sched([_pending_task(5.0, now, tenant="victim")])
    mon, names = _only(cfg, scheds=[sched])
    assert names == ["starvation"]
    a = mon.alerts()[0]
    assert a["labels"]["tenant"] == "victim"
    assert a["value"] > 1.0 and a["threshold"] == 1.0
    st = mon.detector_state()["starvation"]
    assert st["tenant"] == "victim" and st["wait_s"] > 1.0


def test_starvation_uses_scheduler_bound_over_default():
    cfg = DetectorConfig(starvation_bound_s=1.0, convoy_slowdown=None,
                         preempt_response_target_s=None)
    now = time.perf_counter()
    sched = _stub_sched([_pending_task(5.0, now)], bound=10.0)
    assert _only(cfg, scheds=[sched])[1] == []


def _slowdowns(n, v):
    def feed(reg, now):
        h = reg.histogram("task_slowdown_ratio", size_class="short")
        for _ in range(n):
            h.observe(v, t=now)
    return feed


def test_convoy_detector_fires_alone():
    cfg = DetectorConfig(starvation_bound_s=None, convoy_slowdown=8.0,
                         convoy_min_tasks=6, preempt_response_target_s=None)
    mon, names = _only(cfg, _slowdowns(8, 20.0))
    assert names == ["convoy"]
    assert mon.detector_state()["convoy"]["size_class"] == "short"


def test_convoy_needs_min_samples():
    cfg = DetectorConfig(starvation_bound_s=None, convoy_slowdown=8.0,
                         convoy_min_tasks=6, preempt_response_target_s=None)
    assert _only(cfg, _slowdowns(3, 50.0))[1] == []


def test_preempt_regression_detector_fires_alone():
    cfg = DetectorConfig(starvation_bound_s=None, convoy_slowdown=None,
                         preempt_response_target_s=0.01,
                         preempt_min_samples=5)

    def feed(reg, now):
        h = reg.histogram("preempt_response_seconds", region=0)
        for _ in range(6):
            h.observe(0.2, t=now)

    assert _only(cfg, feed)[1] == ["preempt_response"]


def test_alert_resolves_when_condition_clears():
    cfg = DetectorConfig(starvation_bound_s=None, convoy_slowdown=8.0,
                         convoy_min_tasks=2, convoy_window_s=5.0,
                         preempt_response_target_s=None)
    reg = MetricsRegistry()
    mon = TelemetryMonitor(reg, detectors=cfg)
    now = time.perf_counter()
    h = reg.histogram("task_slowdown_ratio", size_class="short")
    for _ in range(4):
        h.observe(30.0, t=now)
    mon.sample(now=now)
    assert [a["name"] for a in mon.alerts()] == ["convoy"]
    assert mon.n_fired == 1
    mon.sample(now=now + 60.0)
    assert mon.alerts() == []
    assert [a["name"] for a in mon.resolved()] == ["convoy"]
    assert mon.n_fired == 1


# -- SLO burn rates -----------------------------------------------------------

def _slo_monitor(policy):
    reg = MetricsRegistry()
    cfg = DetectorConfig(starvation_bound_s=None, convoy_slowdown=None,
                         preempt_response_target_s=None)
    return reg, TelemetryMonitor(reg, policies=[policy], detectors=cfg)


ACME = dict(tenant="acme", latency_target_s=0.1, miss_budget=0.1,
            short_window_s=5.0, long_window_s=30.0, burn_threshold=2.0)


def test_slo_burn_fires_on_both_windows():
    reg, mon = _slo_monitor(SloPolicy(**ACME))
    now = time.perf_counter()
    h = reg.histogram("task_turnaround_seconds", tenant="acme")
    for i in range(20):                   # half the traffic misses: burn 5x
        h.observe(0.5 if i % 2 else 0.01, t=now - 1.0)
    mon.sample(now=now)
    assert [a["name"] for a in mon.alerts()] == ["slo_burn"]
    st = mon.slo_state()["acme"]["task_turnaround_seconds"]
    assert st["burn_short"] == pytest.approx(5.0)
    assert st["burn_long"] == pytest.approx(5.0)


def test_slo_burn_needs_both_windows():
    reg, mon = _slo_monitor(SloPolicy(**ACME))
    now = time.perf_counter()
    h = reg.histogram("task_turnaround_seconds", tenant="acme")
    for _ in range(20):
        h.observe(0.5, t=now - 20.0)      # old misses: long window only
    for _ in range(10):
        h.observe(0.01, t=now - 1.0)      # fresh traffic is healthy
    mon.sample(now=now)
    assert mon.alerts() == []


def test_slo_policy_validation():
    with pytest.raises(ValueError):
        SloPolicy(miss_budget=0.0).validate()
    with pytest.raises(ValueError):
        SloPolicy(short_window_s=60.0, long_window_s=5.0).validate()
    with pytest.raises(ValueError):
        SloPolicy(burn_threshold=0.0).validate()


def test_telemetry_section_states():
    assert telemetry_section(None) == {"enabled": False}
    reg = MetricsRegistry()
    sec = telemetry_section(reg)
    assert sec["enabled"] is True and sec["sampler"] is False
    TelemetryMonitor(reg).sample()
    sec = telemetry_section(reg)
    assert sec["sampler"] is True and sec["samples"] == 1


# -- starvation-aware coalescing bound (the port's policies) ------------------

class _Args:
    def signature(self):
        return ("sig",)


def _ptask(kernel="K", priority=0, tenant="default", wait_s=0.0):
    t = Task(kernel=kernel, args=_Args(), priority=priority, tenant=tenant)
    t.status = TaskStatus.QUEUED
    t.t_arrived = time.perf_counter() - wait_s
    return t


@pytest.mark.parametrize("make_policy", [
    lambda: FcfsPriority(5),
    lambda: EarliestDeadlineFirst(),
    lambda: WeightedFairShare(),
], ids=["fcfs", "edf", "wfq"])
def test_coalesce_refused_past_starving_head(make_policy):
    pol = make_policy()
    pol.enqueue(_ptask(kernel="A", wait_s=10.0))
    for _ in range(4):
        pol.enqueue(_ptask(kernel="B"))
    matches = lambda t: t.kernel == "B"  # noqa: E731
    region = SimpleNamespace(rid=0, geometry=(1,), current_task=None)
    got = pol.peek_same_bitstream(matches, region, window=8)
    assert got is not None and got.kernel == "B"
    assert pol.peek_same_bitstream(matches, region, window=8,
                                   max_skip_wait_s=5.0) is None
    got = pol.peek_same_bitstream(matches, region, window=8,
                                  max_skip_wait_s=60.0)
    assert got is not None and got.kernel == "B"


def test_coalesce_stream_drains_until_starvation():
    pol = FcfsPriority(5)
    victim = _ptask(kernel="A")
    victim.t_arrived = time.perf_counter() - 0.95   # 50 ms short of the bound
    pol.enqueue(victim)
    for _ in range(6):
        pol.enqueue(_ptask(kernel="B"))
    region = SimpleNamespace(rid=0, geometry=(1,), current_task=None)
    matches = lambda t: t.kernel == "B"  # noqa: E731
    served = 0
    deadline = time.time() + 10.0
    while time.time() < deadline:
        t = pol.peek_same_bitstream(matches, region, window=8,
                                    max_skip_wait_s=1.0)
        if t is None:
            break
        assert pol.take(t)
        served += 1
        time.sleep(0.02)
    assert served < 6
    assert any(t is victim for t in pol.pending_tasks())


def test_starvation_bound_config_validation():
    from repro_torch.core.scheduler import SchedulerConfig

    with pytest.raises(ValueError):
        SchedulerConfig(starvation_bound_s=0.0).validate()
    SchedulerConfig(starvation_bound_s=2.5).validate()


# -- live runs ----------------------------------------------------------------

SIZE = 16


def _blur_task(rng, tenant="default"):
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.kernels.blur.tasks import make_image

    img = make_image(rng, SIZE)
    kd = get_kernel("MedianBlur")
    return Task(kernel="MedianBlur",
                args=kd.bundle(img, np.zeros_like(img), H=SIZE, W=SIZE,
                               iters=1),
                tenant=tenant)


def test_live_run_scrape_and_report():
    """A metered run on the CPU scrapes as Prometheus text with per-tenant
    histograms, the report carries the telemetry section, and the max
    queue wait surfaces per priority and per tenant."""
    from repro_torch.client import Client

    rng = np.random.default_rng(0)
    reg = MetricsRegistry()
    client = Client(n_regions=2, metrics=reg, prefetch=False, device="cpu")
    mon = TelemetryMonitor(reg).attach(scheduler=client.scheduler)
    srv = MetricsHTTPServer(reg, port=0)
    try:
        handles = [client.submit(_blur_task(rng, tenant=f"t{i % 2}"))
                   for i in range(4)]
        for h in handles:
            h.result(60.0)
        mon.sample()
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=5) as r:
            txt = r.read().decode()
        assert "# TYPE repro_task_turnaround_seconds histogram" in txt
        assert 'tenant="t0"' in txt and 'tenant="t1"' in txt
        assert "repro_region_occupancy" in txt
        for name in ("icap_hold_seconds", "icap_wait_seconds",
                     "compile_seconds", "region_reconfig_seconds",
                     "kernels_run_total", "dispatches_total"):
            assert f"repro_{name}" in txt, name
        rep = client.report()
        tele = rep["telemetry"]
        assert tele["enabled"] and tele["sampler"]
        for d in rep["service_by_priority"].values():
            assert "max_queue_wait_s" in d
        for d in rep["per_tenant"].values():
            assert "max_queue_wait_s" in d
        assert client.alerts == []
        assert client.metrics is reg and client.tracer is None
        assert reg.counter("tasks_done_total", tenant="t0").value == 2
    finally:
        srv.close()
        client.shutdown()


def _attention_streams(tracer=None, metrics=None):
    from repro_torch.client import Client
    from repro_torch.serving import attention as A

    P = A.AttentionParams()
    cfg = dict(lm="attention", d_model=P.d_model, vocab_size=P.vocab,
               max_slots=3, round_tokens=4)
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(0, P.vocab, size=n)]
               for n in (3, 7, 12, 5)]
    with Client(n_regions=2, device="cpu", chunk_budget=2, prefetch=False,
                serving=cfg, tracer=tracer, metrics=metrics) as client:
        handles = [client.stream(pr, max_new_tokens=6 + i, seed=i)
                   for i, pr in enumerate(prompts)]
        got = [h.result(timeout=TIMEOUT) for h in handles]
        rep = client.serving_report()
        assert client.tracer is tracer and client.metrics is metrics
    want = [A.attention_oracle_stream(pr, 6 + i, P, max_slots=3,
                                      round_tokens=4)
            for i, pr in enumerate(prompts)]
    return got, want, rep


def test_traced_metered_attention_stream():
    """``Client(tracer=, metrics=, serving={"lm": "attention"})`` on the
    CPU: the streams equal the oracle's and an untraced run's; the tokens
    counter equals the tokens streamed, the TTFT histogram counts one per
    sequence, and the ``decode_round`` spans number the engine's rounds."""
    tracer, reg = P_obs.Tracer(), MetricsRegistry()
    got, want, rep = _attention_streams(tracer, reg)
    plain, _, plain_rep = _attention_streams()
    assert got == want == plain
    n_tokens = sum(len(s) for s in got)
    assert rep["tokens_out"] == n_tokens
    tokens = sum(inst.value for kind, name, _l, inst in reg.series()
                 if name == "serving_tokens_total")
    ttft = sum(inst.n for kind, name, _l, inst in reg.series()
               if name == "serving_ttft_seconds")
    assert tokens == n_tokens and ttft == len(got)
    assert reg.counter("serving_decode_rounds_total").value == \
        rep["decode_rounds"]
    evs = tracer.events()
    rounds = [e for e in evs if e.kind == "decode_round"]
    assert len(rounds) == rep["decode_rounds"] > 0
    assert all(e.track == ("serving", 0) and e.dur > 0 for e in rounds)
    assert sum(e.kind == "seq_submit" for e in evs) == len(got)
    assert sum(e.kind == "ttft" for e in evs) == len(got)
    assert rep["trace"]["enabled"] and rep["telemetry"]["enabled"]
    assert plain_rep["trace"] == {"enabled": False}
    assert plain_rep["telemetry"] == {"enabled": False}


def test_top_cli_once(tmp_path):
    """``tools/top.py --stream ... --once`` renders a frame from the port's
    JSONL snapshot."""
    path = tmp_path / "t.jsonl"
    reg = MetricsRegistry()
    reg.gauge("region_occupancy", region=0).set(0.5)
    reg.counter("tasks_done_total", tenant="a").inc(3)
    mon = TelemetryMonitor(reg)
    w = JsonlMetricsWriter(str(path))
    mon.add_sink(w)
    mon.sample()
    w.close()
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "top.py"),
         "--stream", str(path), "--once"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "regions" in out.stdout and "tenant shares" in out.stdout
    assert "alerts: none" in out.stdout
