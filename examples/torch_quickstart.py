"""Quickstart for the PyTorch/CUDA port — the paper's use case end to end
through ``repro_torch.Client``, the twin of ``examples/quickstart.py``.

A card is split into two reconfigurable regions (CUDA streams); blur tasks
of mixed priority arrive; a high-priority task preempts a running
low-priority one (its context checkpoints to the region's bank and it
resumes later).  The same client then streams two token-serving sequences.

    PYTHONPATH=src python examples/torch_quickstart.py               # cuda:0
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain

On the card the frames are 4096 x 4096, as in ``chip_smoke.py``; on the CPU
they are 200 x 200 and each chunk is stretched by 50 ms, as in the
reference's quickstart.
"""
import argparse
import threading

import numpy as np

import repro_torch
from repro_torch.controller.hittile import HitTile
from repro_torch.kernels.blur.tasks import make_image
from repro_torch.serving.engine import ServingConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions; default "
                         "cuda:0")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    size, slowdown_s = (200, 0.05) if on_cpu else (4096, 0.0)
    rng = np.random.default_rng(0)

    # One client = one shell with 2 reconfigurable regions (paper §4.1);
    # chunk_budget bounds the preemption latency.
    client = repro_torch.Client(n_regions=2, chunk_budget=2,
                                device=args.device,
                                serving=ServingConfig(d_model=32,
                                                      vocab_size=257))
    # the urgent task arrives once both background tasks are running
    started, both = set(), threading.Event()

    def on_chunk(region, task):
        started.add(task.tid)
        if len(started) >= 2:
            both.set()

    for r in client.shell.regions:
        r.slowdown_s = slowdown_s  # pretend tasks are long (CPU demo)
        r.on_chunk = on_chunk

    # Low-priority background work ...
    img1, img2 = make_image(rng, size), make_image(rng, size)
    bg = client.launch("MedianBlur", (HitTile.of(img1),
                                      HitTile.zeros(img1.shape)),
                       priority=4, H=size, W=size, iters=3)
    bg2 = client.launch("MedianBlur", (HitTile.of(img2),
                                       HitTile.zeros(img2.shape)),
                        priority=4, H=size, W=size, iters=3)

    # ... and an URGENT task arriving a moment later: with both regions
    # busy, the scheduler preempts a priority-4 task to serve it.
    if not both.wait(120):
        raise RuntimeError("the background tasks never started")
    img3 = make_image(rng, size)
    urgent = client.launch("GaussianBlur", (HitTile.of(img3),
                                            HitTile.zeros(img3.shape)),
                           priority=0, H=size, W=size, iters=1)

    urgent.result(timeout=120)
    bg.result(timeout=120), bg2.result(timeout=120)

    # same client, same handle idiom: stream generated tokens live
    s1 = client.stream([3, 1, 4, 1, 5], max_new_tokens=8, seed=1)
    s2 = client.stream([2, 7, 1, 8], max_new_tokens=8, seed=2)
    print(f"\nstreamed tokens: {list(s1)} and {list(s2)}")

    report = client.report()
    client.shutdown()

    bgt, bg2t, ut = bg.task, bg2.task, urgent.task
    print("\n--- report ---")
    print(f"tasks done:        {report['n_done']}")
    print(f"preemptions:       {report['preemptions']}")
    print(f"partial reconfigs: {report['reconfigs']} "
          f"(cache hits {report['cache_hits']}, "
          f"cold compiles {report['cold_compiles']})")
    print(f"urgent service time: {ut.service_time*1000:.1f} ms "
          f"(background: {bgt.service_time*1000:.1f} ms)")
    print(f"background was preempted {bgt.n_preemptions + bg2t.n_preemptions}x "
          f"and still produced the right result: "
          f"{np.isfinite(np.asarray(bgt.result[1])).all()}")


if __name__ == "__main__":
    main()
