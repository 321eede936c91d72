"""Versioned report schema (one source of truth for observability keys).

A copy of the reference's ``repro.core.reporting``, key for key, so a
port report is checked against the same schema.

The system has report surfaces — ``Scheduler.report()``, the shell's
``reconfig_report()``, and the cluster aggregate — whose key sets drifted
independently; CI smokes and benchmarks scrape them by name, so an
undocumented rename is a silent breakage.  This module pins them down:

- every report dict is stamped with ``report_version`` (currently 1) and
  a ``layer`` tag naming which schema it follows;
- ``SCHEMA`` documents every top-level key each layer may emit, with a
  one-line description (the machine-readable changelog for consumers);
- ``undocumented(layer, report)`` returns emitted-but-undocumented keys —
  the schema test asserts it is empty for a real report from every layer,
  so adding a key without documenting it fails CI.

Nested sub-dicts (``pool``, ``per_tenant``, ``per_shell``, ``regions``,
``per_key``) are documented as a single key here; their internal layout is
owned by the producing module.  Bumping ``REPORT_VERSION`` is reserved for
a breaking change (key removed or retyped), not for additions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

REPORT_VERSION = 1

# one description, shared by every layer that carries a trace section
_TRACE_DOC = ("flight-recorder derived metrics (obs/, DESIGN.md §11): "
              "per-task latency breakdown, preempt response percentiles, "
              "region occupancy, ICAP serialization; {enabled: False} "
              "when no tracer is threaded")

# one description, shared by every layer that carries a telemetry section
_TELEMETRY_DOC = ("live-metrics state (obs/registry.py + obs/slo.py, "
                  "DESIGN.md §12): registry series count, firing/fired "
                  "alerts, starvation/convoy/preempt-regression detector "
                  "outputs, per-tenant SLO burn rates, sampler status; "
                  "{enabled: False} when no registry is threaded")


def safe_rate(count: float, wall_s: float) -> float:
    """``count / wall_s`` that reports 0.0 for an instant, unmeasured, or
    non-finite window instead of raising or emitting an inf-like rate.

    CI smokes can legitimately observe ``wall_s == 0`` (a report sampled
    before the first completion, or a run whose start and end stamps
    coincide at clock resolution); a throughput of 0.0 is the honest
    answer there, where ``count / max(wall, 1e-9)`` fabricates a 1e9-scale
    one."""
    if not isinstance(wall_s, (int, float)) or not math.isfinite(wall_s):
        return 0.0
    if wall_s <= 0.0:
        return 0.0
    return count / wall_s

# keys every stamped report carries, regardless of layer
_ENVELOPE = {
    "report_version": "schema version of this report (this file)",
    "layer": "which schema the report follows: scheduler | shell_reconfig "
             "| cluster | serving",
}

_SCHEDULER = {
    "n_done": "tasks completed by this scheduler",
    "wall_s": "wall-clock span from loop start to last completion",
    "throughput_tps": "n_done / wall_s",
    "policy": "scheduling policy name (fcfs | edf | wfq)",
    "service_by_priority": "per-priority service-time stats (paper metric i)",
    "turnaround_p50_s": "median arrival->done latency",
    "turnaround_p99_s": "p99 arrival->done latency",
    "deadline_tasks": "tasks submitted with a deadline",
    "deadline_misses": "deadline tasks that finished late",
    "per_tenant": "per-tenant work/turnaround/deadline breakdown",
    "fairness_ratio": "max/min weighted tenant share (1.0 = perfectly fair)",
    "cancelled": "tasks cancelled via their handles",
    "stranded_handles": "handles left unresolved at loop exit (must be 0)",
    "preemptions": "checkpoint-preemptions across completed tasks",
    "migrations": "cross-region/shell moves recorded on completed tasks",
    "migrated_out": "tasks handed off to another shell by this scheduler",
    "chunks": "preemption chunks executed across all regions",
    "chunks_pipelined": "chunks issued while a predecessor was resolving",
    "chunks_discarded": "speculative identity chunks past done",
    "host_spills_avoided": "device-resident resumes (no host round trip)",
    "megakernel_launches": "single-dispatch megakernel launches",
    "flag_poll_exits": "megakernel launches exited on the preempt flag",
    "coalesced_dispatches": "same-bitstream back-to-back dispatches",
    "reconfigs": "partial bitstream loads",
    "full_reconfigs": "full-fabric reconfigurations (baseline mode)",
    "cache_hits": "bitstream cache hits",
    "cold_compiles": "demand compiles on the dispatch path",
    "prefetch_compiles": "compiles done off the dispatch path",
    "prefetch_hits": "dispatches that consumed a prefetched bitstream",
    "prefetch_hit_rate": "prefetch_hits over prefetch-eligible loads",
    "prefetch_stale_drops": "prefetched bitstreams dropped unused",
    "evictions": "bitstream cache evictions",
    "dispatch_stall_s": "wall time dispatch spent waiting on compiles",
    "pool": "region-pool capacity/utilization stats (elastic or static)",
    "reconfig": "nested shell_reconfig report (deduplicated detail)",
    "trace": _TRACE_DOC,
    "telemetry": _TELEMETRY_DOC,
}

_SHELL_RECONFIG = {
    "partial_loads": "bitstream loads through the ICAP path",
    "full_reconfigs": "full-fabric reconfigurations",
    "cache_hits": "bitstream cache hits",
    "cold_compiles": "demand compiles on the dispatch path",
    "prefetch_compiles": "compiles done off the dispatch path",
    "prefetch_hits": "dispatches that consumed a prefetched bitstream",
    "prefetch_hit_rate": "prefetch_hits over prefetch-eligible loads",
    "prefetch_stale_drops": "prefetched bitstreams dropped unused",
    "inflight_joins": "compile requests that joined an in-flight compile",
    "evictions": "bitstream cache evictions",
    "total_stall_s": "cumulative dispatch stall behind compiles",
    "total_partial_s": "cumulative partial-load (ICAP) latency",
    "total_compile_s": "cumulative bitstream compile time",
    "avg_partial_s": "mean partial-load latency",
    "cache_capacity": "LRU bitstream cache capacity (None = unbounded)",
    "cache_size": "bitstreams currently cached",
    "per_key": "per-bitstream hit/miss/eviction detail",
    "prefetcher": "prefetch worker queue counters",
    "regions": "per-region reconfig/chunk counters, incl. pallas_mode "
               "(interpret | compiled) of the last Pallas bitstream",
}

_CLUSTER = {
    "cluster": "always True (marks the aggregate report)",
    "n_shells": "shells in the fabric",
    "router": "global routing policy name",
    "rebalance": "whether the load rebalancer was enabled",
    "n_submitted": "tasks submitted through the frontend",
    "n_done": "tasks completed cluster-wide",
    "n_failed": "tasks terminally failed (lost)",
    "wall_s": "frontend wall-clock span (first submit to last resolve)",
    "throughput_tps": "n_done / wall_s",
    "turnaround_p50_s": "median submit->resolve latency across shells",
    "turnaround_p99_s": "p99 submit->resolve latency across shells",
    "lost_tasks": "alias of n_failed (tasks no shell could finish)",
    "dead_shells": "node ids declared dead by the heartbeat monitor",
    "failovers": "whole-shell failure recoveries",
    "cancelled": "tasks cancelled via cluster handles",
    "stranded_handles": "cluster handles unresolved at shutdown (must be 0)",
    "migrations_attempted": "cross-shell migrations started",
    "migrations_completed": "cross-shell migrations that finished",
    "failover_events": "per-failover detail records",
    "energy_j_total": "summed per-shell energy model estimate",
    "per_shell": "per-shell scheduler/health/energy breakdown",
    "trace": _TRACE_DOC,
    "telemetry": _TELEMETRY_DOC,
}

_SERVING = {
    "n_sequences": "sequences submitted to the serving engine",
    "n_finished": "sequences that streamed every token",
    "n_failed": "sequences terminally failed",
    "n_cancelled": "sequences cancelled before finishing",
    "stranded_sequences": "sequences unresolved at engine close (must be 0)",
    "tokens_out": "generated tokens streamed to clients",
    "tokens_per_s": "tokens_out over the serving window",
    "wall_s": "first submit to last sequence completion",
    "ttft_p50_s": "median time-to-first-token (submit -> prefill token)",
    "ttft_p99_s": "p99 time-to-first-token",
    "prefill_tasks": "prefill tasks dispatched (the attention LM packs "
                     "up to prefill_batch sequences into one)",
    "decode_rounds": "decode round tasks dispatched",
    "slot_inserts": "sequences admitted into a decode slot",
    "slot_evictions": "finished sequences evicted from their slot",
    "max_slots_used": "peak concurrently occupied decode slots",
    "decode_preemptions": "checkpoint-preemptions of decode rounds",
    "decode_migrations": "cross-region/shell moves of decode rounds",
    "state_device_rounds": "rounds whose KV state stayed device-resident",
    "engine_mode": "region engine the backend shell runs (None = cluster)",
    "lm": "model backend serving the tokens: surrogate | attention",
    "kv": "paged-KV block-pool stats (blocks_total/in_use/peak, occupancy, "
          "evictions, reuse, alloc_deferred; DESIGN.md §13) — None for "
          "LMs without a KV cache",
    "trace": _TRACE_DOC,
    "telemetry": _TELEMETRY_DOC,
}

SCHEMA: Dict[str, Dict[str, str]] = {
    "scheduler": {**_ENVELOPE, **_SCHEDULER},
    "shell_reconfig": {**_ENVELOPE, **_SHELL_RECONFIG},
    "cluster": {**_ENVELOPE, **_CLUSTER},
    "serving": {**_ENVELOPE, **_SERVING},
}


@dataclass(frozen=True)
class ReportEnvelope:
    """The shared stamp every report layer emits (dataclass -> dict)."""
    layer: str
    report_version: int = REPORT_VERSION
    payload: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        if self.layer not in SCHEMA:
            raise ValueError(
                f"unknown report layer {self.layer!r}; "
                f"known: {sorted(SCHEMA)}")
        out = dict(self.payload)
        out["report_version"] = self.report_version
        out["layer"] = self.layer
        return out


def stamp(layer: str, report: dict) -> dict:
    """Stamp ``report`` in place with the versioned envelope."""
    return ReportEnvelope(layer=layer, payload=report).to_dict()


def documented_keys(layer: str) -> set:
    return set(SCHEMA[layer])


def undocumented(layer: str, report: dict) -> set:
    """Top-level keys ``report`` emits that the schema does not document
    (the schema test asserts this is empty for every layer)."""
    return set(report) - documented_keys(layer)
