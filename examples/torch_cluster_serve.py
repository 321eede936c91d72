"""Multi-shell cluster demo for the PyTorch/CUDA port, the twin of
``examples/cluster_serve.py``: two shells behind one
``repro_torch.Client``, a long task checkpoint-migrated from shell 0 to
shell 1 mid-run (bit-identical result), then a whole-shell failure whose
outstanding tasks fail over to the survivor — nothing lost.

    PYTHONPATH=src python examples/torch_cluster_serve.py               # cuda:0
    PYTHONPATH=src python examples/torch_cluster_serve.py --device cpu  # plain

On the card both shells are CUDA streams on cuda:0 and the frames are
4096 x 4096, as in ``chip_smoke.py``; on the CPU they are 200 x 200.  The
migration and the failure land at chunk boundaries: a region's
``on_chunk`` hook holds the task's worker at its k-th boundary until this
thread has asked for the move (``migrate``) or killed the shell
(``inject_failure``), so the demo needs no sleeps.
"""
import argparse
import threading
import time

import numpy as np

import repro_torch
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.task import Task
from repro_torch.kernels.blur.tasks import make_image

ITERS = 3


class Hold:
    """``on_chunk`` hook: at the ``k``-th chunk of task ``tid`` it sets
    ``reached`` and holds the worker until ``release(region)`` is true."""

    def __init__(self, tid, k, release):
        self.tid, self.k, self.release = tid, k, release
        self.seen = 0
        self.reached = threading.Event()

    def __call__(self, region, task):
        if task.tid != self.tid or self.reached.is_set():
            return
        self.seen += 1
        if self.seen == self.k:
            self.reached.set()
            deadline = time.perf_counter() + 60.0
            while (not self.release(region)
                   and time.perf_counter() < deadline):
                time.sleep(0.001)


def make_task(rng, size):
    img = make_image(rng, size)
    kd = get_kernel("MedianBlur")
    return Task(kernel="MedianBlur",
                args=kd.bundle(img, np.zeros_like(img), H=size, W=size,
                               iters=ITERS),
                priority=2)


def hold_on_every_region(fe, hook):
    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = hook


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions; default "
                         "cuda:0")
    args = ap.parse_args(argv)
    size = 200 if args.device == "cpu" else 4096
    rng = np.random.default_rng(0)
    # the same Client constructor, now a 2-shell cluster fabric; submit()
    # and the returned handles work identically to the one-shell case
    client = repro_torch.Client(n_shells=2, n_regions=1, chunk_budget=2,
                                device=args.device)
    fe = client.cluster

    # -- 1. reference: one task served uninterrupted --------------------
    ref = client.submit(make_task(np.random.default_rng(0), size)).result(
        timeout=300)

    # -- 2. the same payload, checkpoint-migrated between shells --------
    mig_task = make_task(np.random.default_rng(0), size)  # same stream
    hold = Hold(mig_task.tid, 3, lambda r: r._preempt.is_set())
    hold_on_every_region(fe, hold)
    handle = client.submit(mig_task)
    hold.reached.wait(300)   # 3 chunks of checkpointed progress
    moved = fe.migrate(tid=mig_task.tid, prefer="running")
    out = handle.result(timeout=300)
    print(f"migrated={moved}: shells visited {handle.node_history}, "
          f"preempted {handle.task.n_preemptions}x")
    print(f"bit-identical to the uninterrupted run: "
          f"{np.array_equal(out[0], ref[0])}")

    # -- 3. failover: kill shell 0 with work outstanding -----------------
    tasks = [make_task(rng, size) for _ in range(4)]
    hold = Hold(tasks[0].tid, 2, lambda r: r._failed.is_set())
    hold_on_every_region(fe, hold)
    handles = [client.submit(t) for t in tasks]
    hold.reached.wait(300)   # shell 0 is two chunks into its first task
    print("\n!!! injecting whole-shell failure on shell 0\n")
    fe.nodes[0].inject_failure()
    for h in handles:
        h.result(timeout=300)  # all finish on the survivor

    rep = client.shutdown()
    print("--- cluster report ---")
    print(f"tasks done:   {rep['n_done']} / {rep['n_submitted']}"
          f"  (lost: {rep['lost_tasks']}, stranded: "
          f"{rep['stranded_handles']})")
    print(f"migrations:   {rep['migrations_completed']} completed")
    print(f"failovers:    {rep['failovers']} -> {rep['failover_events']}")
    print(f"turnaround:   p50 {rep['turnaround_p50_s']:.3f}s / "
          f"p99 {rep['turnaround_p99_s']:.3f}s")
    for nid, s in rep["per_shell"].items():
        print(f"  shell {nid}: {s['n_done']} done, "
              f"{s['migrated_out']} migrated out"
              + (f", crashed ({s['crash']})" if s["crash"] else ""))


if __name__ == "__main__":
    main()
