"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell; its
configuration, traffic mix and metric readers are found by name under
``perfbench/``.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number compared
beside its limit, which are also the last lines of standard error).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run under ``torch.profiler`` and the program's
flight recorder.  Exit codes: 0 a result was printed, 2 no card or too
few, 3 a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be (whole names:
    ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result(cell, run, checks) -> dict:
    """The result line's object for a finished run."""
    from perfbench.harness import spec

    attempted = len(run.sent())
    failed = sum(not r.ok for r in run.sent())
    metrics = {}
    for m in cell.metrics(run.trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device_kind != "cpu" else "cpu",
              "kind": run.device_kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": (failed == 0 and bool(checks)
                       and all(c["n"] > 0 and c["value"] <= c["limit"]
                               for c in checks)),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if run.trace and run.dev is not None:
        device["busy_s"] = run.dev.busy_s()
        device["window_s"] = run.dev.window_s
        ops = sorted(run.dev.by_name().items(), key=lambda kv: -kv[1])[:10]
        shift = run.dev.lo_us - run.t0 * 1e6
        # the program's activity spans (a slot's occupancy is no activity)
        spans = [(e.kind, e.t * 1e6 + shift, (e.t + e.dur) * 1e6 + shift)
                 for e in run.events if e.dur > 0 and e.kind != "slot_busy"]
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in ops],
                            "idle_gaps": run.dev.idle_by_host(spans)}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device=None, cell=None, t_start=None) -> dict:
    """One run of ``workload`` (or of ``cell``, already resolved): the
    result line's object.  ``device="cpu"`` runs the plain kernels."""
    from perfbench.harness import check, drive, spec

    cell = cell or spec.resolve(workload)
    run = drive.run_cell(cell, seed, seconds, trace, device=device,
                         t_start=t_start)
    checks = check.checks(run)
    out = result(cell, run, checks)
    out["_run"] = run
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel cache stays inside the checkout, at fixed paths (the
    # program builds its own CUDA libraries into build/repro_torch/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    from perfbench.harness import spec

    cell = spec.resolve(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  cell=cell, t_start=T_START)
    run = out.pop("_run")
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed}: set-up "
          f"{run.setup_s:.3f} s, window {args.seconds} s", file=sys.stderr)
    errors = [r.error for r in run.blur if r.error]
    if errors:
        print(f"perfbench: {len(errors)} answer(s) failed, the first: "
              f"{errors[0]}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
