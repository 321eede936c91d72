"""The port's reports against the versioned schema (``core/reporting.py``,
a copy of the reference's): the twins of ``tests/test_report_schema.py``,
run on ``devices=["cpu"]``, and the ``trace``/``telemetry`` sections of a traced,
metered run laid out key for key as the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

from repro import obs as R_obs  # noqa: E402
from repro.controller import kernels as R_kernels  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.controller import kernels as P_kernels  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402
from repro_torch.core.reporting import (REPORT_VERSION, SCHEMA,  # noqa: E402
                                        documented_keys, undocumented)
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402

TRACE_KEYS = ("capacity", "emitted", "dropped", "n_events", "kinds",
              "per_task", "preempt_response", "regions", "icap")
TELEMETRY_KEYS = ("n_series", "alerts", "alerts_fired_total", "detectors",
                  "slo", "samples")


def _check(layer, rep):
    assert rep["report_version"] == REPORT_VERSION
    assert rep["layer"] == layer
    extra = undocumented(layer, rep)
    assert not extra, (f"{layer} report emits undocumented keys {extra}; "
                       f"document them in core/reporting.py SCHEMA")


def _task(seed, kernel="MedianBlur", side=None):
    tk, get_kernel = ((P_task.Task, P_kernels.get_kernel) if side is None
                      else side)
    img = make_image(np.random.default_rng(seed), 16)
    return tk(kernel=kernel, priority=2,
              args=get_kernel(kernel).bundle(img, np.zeros_like(img), H=16,
                                             W=16, iters=1))


def _shell(**kw):
    return P_shell.Shell(n_regions=1, devices=["cpu"], chunk_budget=2,
                         prefetch=False, **kw)


def test_schema_layers_complete():
    assert set(SCHEMA) == {"scheduler", "shell_reconfig", "cluster",
                           "serving"}
    for layer in SCHEMA:
        assert documented_keys(layer), layer


def test_scheduler_and_shell_reports_documented():
    shell = _shell()
    try:
        rep = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig()).run(
            [_task(0)], quiet=True)
        _check("scheduler", rep)
        _check("shell_reconfig", shell.reconfig_report())
    finally:
        shell.shutdown()


def test_cluster_report_documented():
    from repro_torch.cluster import ClusterFrontend

    fe = ClusterFrontend(n_shells=2, regions_per_shell=1, chunk_budget=2,
                         rebalance=False, devices=["cpu"])
    rep = fe.shutdown()
    _check("cluster", rep)
    for shell in rep["per_shell"].values():
        assert shell["migrated_out"] == 0


class _NullBackend:
    """A backend the engine never dispatches to; its shell gives the LM its
    device."""

    def __init__(self, tracer=None, metrics=None):
        self.shell = _shell()
        self.shell.shutdown()
        self.tracer, self.metrics = tracer, metrics

    def submit(self, task):  # pragma: no cover - never dispatched
        raise AssertionError("schema test never dispatches")


def test_serving_report_documented():
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    engine = ServingEngine(_NullBackend(), ServingConfig())
    _check("serving", engine.report())


def test_trace_section_schema():
    """The ``trace`` key: ``{enabled: False}`` untraced; under a tracer the
    recorder counters plus every derived section, as one documented key."""
    shell = _shell(tracer=P_obs.Tracer())
    try:
        rep = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig()).run(
            [_task(1)], quiet=True)
    finally:
        shell.shutdown()
    _check("scheduler", rep)
    tr = rep["trace"]
    assert tr["enabled"] is True
    for key in TRACE_KEYS:
        assert key in tr, key
    assert tr["per_task"]["n_tasks"] == 1
    shell2 = _shell()
    try:
        rep2 = P_scheduler.Scheduler(shell2,
                                     P_scheduler.SchedulerConfig()).report()
    finally:
        shell2.shutdown()
    assert rep2["trace"] == {"enabled": False}


def test_telemetry_section_schema():
    """The ``telemetry`` key: ``{enabled: False}`` unmetered; with a
    registry and a monitor the series count and the alert, detector and
    SLO state, as one documented key."""
    reg = P_obs.MetricsRegistry()
    shell = _shell(metrics=reg)
    try:
        sched = P_scheduler.Scheduler(shell, P_scheduler.SchedulerConfig())
        mon = P_obs.TelemetryMonitor(reg).attach(scheduler=sched)
        sched.run([_task(2)], quiet=True)
        mon.sample()
        rep = sched.report()
    finally:
        shell.shutdown()
    _check("scheduler", rep)
    tele = rep["telemetry"]
    assert tele["enabled"] is True and tele["sampler"] is True
    for key in TELEMETRY_KEYS:
        assert key in tele, key
    assert tele["samples"] >= 1 and tele["n_series"] > 0
    assert tele["alerts"] == []
    shell2 = _shell()
    try:
        rep2 = P_scheduler.Scheduler(shell2,
                                     P_scheduler.SchedulerConfig()).report()
    finally:
        shell2.shutdown()
    assert rep2["telemetry"] == {"enabled": False}


def test_serving_report_sections_follow_the_backend():
    """The engine adopts the backend's tracer and registry: with both, the
    serving report's two sections are enabled and documented."""
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    tracer, reg = P_obs.Tracer(), P_obs.MetricsRegistry()
    engine = ServingEngine(_NullBackend(tracer, reg), ServingConfig())
    assert engine.tracer is tracer and engine.metrics is reg
    rep = engine.report()
    _check("serving", rep)
    assert rep["trace"]["enabled"] is True
    assert rep["telemetry"]["enabled"] is True
    assert rep["telemetry"]["sampler"] is False


def _layout(d):
    """Nested key layout of a report section: dicts by key, leaves by
    type class (numbers as one class), per-region/per-task maps by one
    representative entry."""
    if isinstance(d, dict):
        if d and all(k.isdigit() for k in d if isinstance(k, str)) \
                and all(isinstance(k, str) for k in d):
            return {"<id>": _layout(next(iter(d.values())))}
        return {k: _layout(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return ["<item>"] if d else []
    if isinstance(d, bool) or d is None:
        return type(d).__name__
    return "number" if isinstance(d, (int, float)) else type(d).__name__


def _sections(obs, shell_cls, sched_mod, side, **shell_kw):
    tracer, reg = obs.Tracer(), obs.MetricsRegistry()
    shell = shell_cls(n_regions=1, chunk_budget=2, prefetch=False,
                      tracer=tracer, metrics=reg, **shell_kw)
    try:
        sched = sched_mod.Scheduler(shell, sched_mod.SchedulerConfig())
        mon = obs.TelemetryMonitor(reg).attach(scheduler=sched)
        sched.run([_task(3, k, side) for k in ("MedianBlur",
                                               "GaussianBlur")], quiet=True)
        mon.sample()
        rep = sched.report()
    finally:
        shell.shutdown()
    return rep


@pytest.mark.parametrize("section", ["trace", "telemetry"])
def test_sections_laid_out_as_the_references(section):
    port = _sections(P_obs, P_shell.Shell, P_scheduler,
                     (P_task.Task, P_kernels.get_kernel), devices=["cpu"])
    ref = _sections(R_obs, R_shell.Shell, R_scheduler,
                    (R_task.Task, R_kernels.get_kernel))
    _check("scheduler", port)
    assert _layout(port[section]) == _layout(ref[section])
    if section == "trace":
        assert port["trace"]["kinds"] == ref["trace"]["kinds"]
        assert port["trace"]["per_task"]["n_tasks"] == 2
    else:
        assert port["telemetry"]["samples"] == ref["telemetry"]["samples"]
