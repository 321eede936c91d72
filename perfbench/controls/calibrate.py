"""Read the numbers that decide ``correct`` for the program and for its
control (the reference in the nearest lower precision) over several seeds,
on the card, one process a cell: the readings the limits are set from.

    python3 perfbench/controls/calibrate.py --workload blur-2rr-batch \\
        --seeds 11,12,13 --seconds 10

Each seed is a whole run of the cell (set-up, the window at the cell's own
load, the check); one JSON line a seed on standard output.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import check, drive, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = drive.run_cell(cell, seed, args.seconds, False)
        rows = check.checks(run, control=True)
        failed = sum(not r.ok for r in run.sent())
        metrics = {m["name"]: spec.reader(m["name"])(run)
                   for m in cell.end_to_end}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "failed": failed, "checks": rows,
                          "metrics": metrics,
                          "seconds": time.perf_counter() - t}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
