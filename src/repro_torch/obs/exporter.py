"""Telemetry sinks: Prometheus text exposition, an HTTP scrape endpoint,
and a JSONL snapshot stream (DESIGN.md §12).

Only the standard library is used — ``http.server`` carries the scrape
endpoint (``serve ... --metrics-port``), a plain append-mode file the
JSONL stream (``--metrics-stream PATH``).  ``tools/top.py`` renders a
live terminal view from either sink.

Endpoints:

- ``GET /metrics`` — Prometheus text format (``# TYPE`` per family;
  histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``),
  every name prefixed ``repro_``;
- ``GET /telemetry.json`` — the full registry snapshot plus the
  monitor's alerts/detectors/SLO state, JSON-encoded (what ``top.py``
  polls).

A copy of the reference's ``repro.obs.exporter``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry

_PREFIX = "repro_"


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{_sanitize(str(k))}="{_escape(str(v))}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every series in Prometheus text exposition format."""
    families: dict = {}  # (name, kind) -> list of lines
    for kind, name, labels, inst in registry.series():
        metric = _PREFIX + _sanitize(name)
        fam = families.setdefault((metric, kind), [])
        if kind == "counter":
            fam.append(f"{metric}{_fmt_labels(labels)} "
                       f"{_fmt_num(inst.value)}")
        elif kind == "gauge":
            fam.append(f"{metric}{_fmt_labels(labels)} "
                       f"{_fmt_num(inst.value)}")
        else:  # histogram: cumulative le buckets + sum + count
            with inst._lock:
                bounds = inst.bounds
                counts = list(inst.counts)
                total, s = inst.n, inst.sum
            cum = 0
            for bound, c in zip(bounds, counts):
                cum += c
                fam.append(f"{metric}_bucket"
                           f"{_fmt_labels(labels, {'le': repr(bound)})}"
                           f" {cum}")
            fam.append(f"{metric}_bucket"
                       f"{_fmt_labels(labels, {'le': '+Inf'})} {total}")
            fam.append(f"{metric}_sum{_fmt_labels(labels)} {_fmt_num(s)}")
            fam.append(f"{metric}_count{_fmt_labels(labels)} {total}")
    lines = []
    for (metric, kind), fam in sorted(families.items()):
        lines.append(f"# TYPE {metric} {kind}")
        lines.extend(fam)
    return "\n".join(lines) + ("\n" if lines else "")


def telemetry_json(registry: MetricsRegistry) -> dict:
    """The /telemetry.json document: snapshot + monitor state."""
    snap = registry.snapshot()
    mon = getattr(registry, "monitor", None)
    snap["alerts"] = mon.alerts() if mon is not None else []
    snap["detectors"] = mon.detector_state() if mon is not None else {}
    snap["slo"] = mon.slo_state() if mon is not None else {}
    return snap


class MetricsHTTPServer:
    """Daemon-threaded scrape endpoint over one registry.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port``.  ``close()`` is idempotent.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        reg = registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] == "/metrics":
                    body = prometheus_text(reg).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/telemetry.json":
                    body = json.dumps(telemetry_json(reg)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"metrics-http:{self.port}")
        self._thread.start()
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class JsonlMetricsWriter:
    """Append one JSON document per sampler tick to ``path``.

    Registered as a :class:`~repro_torch.obs.slo.TelemetryMonitor` sink; the
    file is line-buffered JSONL so ``tools/top.py --stream`` and CI can
    tail it while the run is live.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self.n_written = 0

    def write(self, snapshot: dict) -> None:
        line = json.dumps(snapshot, default=str)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            self.n_written += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
