"""Elastic fault tolerance demo for the PyTorch/CUDA port, the twin of
``examples/failure_recovery.py``: a region dies mid-task; the scheduler
recovers the task from the region bank's last committed context, migrates
it to the surviving region, and re-admits the repaired region.
Submission goes through ``repro_torch.Client`` (the client owns the
serving loop).

    PYTHONPATH=src python examples/torch_failure_recovery.py               # cuda:0
    PYTHONPATH=src python examples/torch_failure_recovery.py --device cpu  # plain

On the card the two regions are CUDA streams on cuda:0 and the frames are
4096 x 4096; on the CPU they are 100 x 100.  The first task is
checkpoint-preempted at its second chunk boundary (so its region's bank
holds a commit) and resumes there; that region is killed at the first
chunk boundary after the resume: the region's ``on_chunk`` hook holds the
worker there until this thread has injected the failure, so the demo
needs no sleeps.
"""
import argparse
import threading
import time

import numpy as np

import repro_torch
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.task import Task
from repro_torch.kernels.blur.tasks import make_image


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions; default "
                         "cuda:0")
    args = ap.parse_args(argv)
    size = 100 if args.device == "cpu" else 4096
    rng = np.random.default_rng(0)
    kd = get_kernel("MedianBlur")
    imgs = [make_image(rng, size) for _ in range(4)]
    tasks = [
        Task(kernel="MedianBlur",
             args=kd.bundle(img, np.zeros_like(img), H=size, W=size,
                            iters=3),
             priority=2)
        for img in imgs
    ]

    shell = Shell(n_regions=2, chunk_budget=1,
                  devices=None if args.device is None else [args.device])
    shell.engine.prewarm("MedianBlur", tasks[0].args, (1,))
    client = repro_torch.Client(backend=shell, scheduler_config=SchedulerConfig(
        preemption=True, repair_after_s=0.8, straggler_factor=None))

    # the first task: preempted at its 2nd chunk (a commit in the bank),
    # then its region killed at the first boundary after the resume
    first, seen = tasks[0], [0]
    reached, victim = threading.Event(), []

    def on_chunk(region, task):
        if task is not first or reached.is_set():
            return
        if task.n_preemptions == 0:
            seen[0] += 1
            if seen[0] == 2:
                region.request_preempt()
            return
        victim.append(region)   # the first chunk after the resume
        reached.set()
        deadline = time.perf_counter() + 60.0
        while (not region._failed.is_set()
               and time.perf_counter() < deadline):
            time.sleep(0.001)

    for r in shell.regions:
        r.on_chunk = on_chunk
    handles = [client.submit(t) for t in tasks]
    reached.wait(300)
    print(f"\n!!! injecting failure into region {victim[0].rid} "
          f"(running task #{first.tid})\n")
    victim[0].inject_failure()
    for h in handles:
        h.result(timeout=300)
    rep = client.drain(timeout=60.0)
    shell.shutdown()

    print("\n--- recovery report ---")
    print(f"tasks done:  {rep['n_done']} / {len(tasks)}")
    print(f"migrations:  {rep['migrations']} (context-preserving)")
    for t in tasks:
        print(f"  task #{t.tid}: regions visited {t.region_history} "
              f"preempted {t.n_preemptions}x migrated {t.n_migrations}x")


if __name__ == "__main__":
    main()
