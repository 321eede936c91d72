"""Flight recorder and live telemetry: structured trace events, Perfetto
export, derived latency metrics, a labelled metrics registry and the
SLO/detector monitor across scheduler, regions, pool and serving.

A copy of the reference's ``repro.obs``, behaviour unchanged: every event
kind, track name, metric name, label and the Prometheus prefix ``repro_``
are the reference's byte for byte, so ``tools/trace_report.py`` and
``tools/top.py`` read the port's output unchanged.  It imports the
standard library only.  Section references ("DESIGN.md §11", "§12") point
at the reference's ``DESIGN.md`` at the repository root.

The paper's headline claims are latency claims (1.66%/4.04% preemption
overhead, "most urgent tasks deployed as fast as possible"); end-of-run
counters cannot show *where* a slow p99 task spent its time.  This package
is the event-level substrate: a lock-cheap bounded ring of timestamped
``TraceEvent``s every layer emits into when a ``Tracer`` handle is threaded
through it (``Shell(tracer=...)``, ``Client(tracer=...)``), a
Chrome-trace-event exporter that renders a run as a Gantt timeline in
ui.perfetto.dev, and a derived-metrics pass that folds the raw stream into
per-task latency breakdowns and preemption response percentiles merged
into ``report()["trace"]``.  Spans are stamped on the host clock
(``time.perf_counter``); what that covers on the card is in the port's
``DESIGN.md``.
"""
from repro_torch.obs.export import export_chrome_trace
from repro_torch.obs.exporter import (JsonlMetricsWriter, MetricsHTTPServer,
                                      prometheus_text, telemetry_json)
from repro_torch.obs.metrics import derive_metrics, trace_section
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.slo import (DetectorConfig, SloPolicy, TelemetryMonitor,
                                 telemetry_section)
from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = ["TraceEvent", "Tracer", "export_chrome_trace",
           "derive_metrics", "trace_section",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SloPolicy", "DetectorConfig", "TelemetryMonitor",
           "telemetry_section",
           "prometheus_text", "telemetry_json", "MetricsHTTPServer",
           "JsonlMetricsWriter"]
