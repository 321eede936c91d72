#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds ``src/repro_torch/csrc/blur.cu`` for ``sm_90a``;
3. kernel vs plain version on the card: median (bitwise) and gaussian
   (max abs difference <= 1e-6) on a [34, 4098] and a [34, 130] row block,
   then a whole 3-iteration median image run through the task code;
4. main path: ``repro_torch.Client(n_regions=2)`` on cuda:0 serves two
   priority-4 MedianBlur tasks (iters=3) on 16-megapixel frames; once both
   have retired a chunk a priority-0 GaussianBlur arrives and preempts one.
   Results must equal the plain version run on the card, and the kernel's
   launch counter, zeroed just before, must read sum(iters x 128) after;
5. times after warm-up, per launch and per whole image: device time from
   ``torch.profiler`` (the JSON's numbers) and back-to-back wall time from
   CUDA events (which includes the host's launch overhead), for the
   kernel, its plain version and (gaussian) one ``conv2d`` call, beside
   the memory bound; then the main path's workload once more without the
   injected slowdown, end to end, and the host<->device copies one task
   pays outside its chunks.

The last three lines of standard output are the kernel JSON record, the
card line, and ``{"ok": true, "device": {...}}``.  The script imports
nothing of the JAX package.  Without CUDA it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIZE = 4096            # 16-megapixel single-channel frame, padded [4098, 4098]
NARROW = 128           # second width for the kernel check: block [34, 130]
BG_ITERS, URGENT_ITERS = 3, 1
SLOWDOWN_S = 0.005     # stretches each chunk so the preemption surely lands
GAUSS_TOL = 1e-6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
OPS_PER_PIXEL = {"median": 72, "gaussian": 17}  # 36 min/max exchanges; 9 mul + 8 add
REPLACES = {"median": "src/repro/kernels/blur/kernel.py:44",
            "gaussian": "src/repro/kernels/blur/kernel.py:50"}
TIMEOUT_S = 300


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3) -> float:
    """Device time of one ``fn()`` in ms: every kernel's duration in the
    window, from ``torch.profiler`` (CUDA activity only), averaged over
    ``reps`` calls after a warm-up.  0.0 when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / reps


def check(kind: str, got, want) -> float:
    err = float((got - want).abs().max())
    if kind == "median":
        if not bool((got == want).all()):
            raise AssertionError(f"median not bitwise equal: max err {err}")
    elif err > GAUSS_TOL:
        raise AssertionError(f"gaussian max err {err} > {GAUSS_TOL}")
    return err


def serve(imgs, slowdown_s: float):
    """The main path: ``repro_torch.Client(n_regions=2)`` on cuda:0, two
    priority-4 MedianBlur tasks, then — once both have retired a chunk — a
    priority-0 GaussianBlur.  The launch counters are zeroed just before
    and read just after.  Returns (background tasks, urgent task, report,
    wall seconds, launches per body)."""
    import numpy as np

    import repro_torch
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.task import Task
    from repro_torch.kernels.blur import kernel as K

    def task(kernel, img, iters, priority):
        return Task(kernel=kernel, priority=priority,
                    args=get_kernel(kernel).bundle(
                        img, np.zeros_like(img), H=SIZE, W=SIZE,
                        iters=iters))

    tasks = [task("MedianBlur", imgs[i], BG_ITERS, 4) for i in (0, 1)]
    urgent = task("GaussianBlur", imgs[2], URGENT_ITERS, 0)
    started, both_started = set(), threading.Event()
    lock = threading.Lock()

    def on_chunk(region, t):
        with lock:
            started.add(t.tid)
            if all(b.tid in started for b in tasks):
                both_started.set()

    client = repro_torch.Client(n_regions=2)
    try:
        for r in client.shell.regions:
            r.slowdown_s = slowdown_s
            r.on_chunk = on_chunk
        K.LAUNCHES.reset()
        t0 = time.perf_counter()
        handles = [client.submit(t) for t in tasks]
        if not both_started.wait(TIMEOUT_S):
            raise AssertionError("background tasks never retired a chunk")
        handles.append(client.submit(urgent))
        for h in handles:
            h.result(timeout=TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] for k in ("median", "gaussian")}
        rep = client.drain(TIMEOUT_S)
    finally:
        client.shutdown()
    return tasks, urgent, rep, wall_s, launches


def log_serve(tag: str, tasks, urgent, rep, wall_s: float, slowdown_s: float):
    chunk_ms = sum(t.run_s for t in (*tasks, urgent)) / rep["chunks"] * 1e3
    log(f"[{tag}] {rep['n_done']} tasks in {wall_s:.3f} s, preemptions "
        f"{rep['preemptions']}, chunks {rep['chunks']} (mean {chunk_ms:.3f} "
        f"ms host per chunk incl. {slowdown_s * 1e3:g} ms slowdown), "
        f"host_spills_avoided {rep['host_spills_avoided']}, reconfigs "
        f"{rep['reconfigs']}, kernel_mode "
        f"{[r['kernel_mode'] for r in rep['reconfig']['regions'].values()]}")
    log(f"[{tag}] urgent service {urgent.service_time * 1e3:.3f} ms, "
        f"turnaround {urgent.turnaround * 1e3:.3f} ms; background "
        f"turnarounds {[round(t.turnaround * 1e3, 3) for t in tasks]} ms; "
        f"chunks_pipelined {rep['chunks_pipelined']}, chunks_discarded "
        f"{rep['chunks_discarded']}, dispatch_stall_s "
        f"{rep['dispatch_stall_s']:.6f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import run_to_completion
    from repro_torch.kernels import native
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur import ref as R
    from repro_torch.kernels.blur.tasks import (ROW_BLOCK, make_image,
                                                result_image)

    # TF32 would change what conv2d computes; the yardstick stays f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(0)

    # 1. card -------------------------------------------------------------
    card = card_line()
    log(f"[card] {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    native.load_library("blur")
    log(f"[build] blur.cu -> {native.build_info['blur']['path']} in "
        f"{time.perf_counter() - t0:.3f} s")
    for line in native.build_info["blur"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. kernel vs plain version --------------------------------------------
    errs = {}
    for w in (SIZE, NARROW):
        block = torch.tensor(rng.random((ROW_BLOCK + 2, w + 2),
                                        dtype=np.float32), device=dev)
        for kind in ("median", "gaussian"):
            got = K.blur_block(block, kind)
            torch.cuda.synchronize()
            err = check(kind, got, R.blur_block(block, kind))
            if w == SIZE:
                errs[kind] = err
            log(f"[check] {kind} [{ROW_BLOCK + 2}, {w + 2}] max_abs_err "
                f"{err:.3e}")
    img = make_image(rng, SIZE)
    kd = get_kernel("MedianBlur")
    bufs, ints, floats = kd.bundle(img, np.zeros_like(img), H=SIZE, W=SIZE,
                                   iters=BG_ITERS).padded()
    ctx, state, _ = run_to_completion(
        kd.fn, ContextRecord.fresh(), tuple(torch.tensor(b, device=dev)
                                            for b in bufs),
        ints, floats, budget=kd.default_budget)
    torch.cuda.synchronize()
    whole_err = check("median", state[BG_ITERS % 2],
                      R.iterated_blur_ref(torch.tensor(img, device=dev),
                                          BG_ITERS, "median"))
    log(f"[check] whole {BG_ITERS}-iteration median image {img.shape}: "
        f"max_abs_err {whole_err:.3e} (done={ctx.done})")
    del state

    # 4. main path ----------------------------------------------------------
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    tasks, urgent, rep, main_s, launches = serve(imgs, SLOWDOWN_S)
    n_rb = SIZE // ROW_BLOCK
    want_launches = {"median": 2 * BG_ITERS * n_rb,
                     "gaussian": URGENT_ITERS * n_rb}
    log_serve("main", tasks, urgent, rep, main_s, SLOWDOWN_S)
    log(f"[main] launches {launches} (expected {want_launches})")
    if rep["preemptions"] < 1:
        raise AssertionError("the urgent task preempted nothing")
    if launches != want_launches:
        raise AssertionError(f"launch count {launches} != {want_launches}")
    for t, im, iters, kind in ((tasks[0], imgs[0], BG_ITERS, "median"),
                               (tasks[1], imgs[1], BG_ITERS, "median"),
                               (urgent, imgs[2], URGENT_ITERS, "gaussian")):
        got = torch.tensor(result_image(t, iters))
        want = R.iterated_blur_ref(torch.tensor(im, device=dev), iters,
                                   kind).cpu()
        err = check(kind, got, want)
        log(f"[main] task #{t.tid} {kind} x{iters}: preempted "
            f"{t.n_preemptions}x on regions {t.region_history}, max_abs_err "
            f"{err:.3e}")

    # 5. times ---------------------------------------------------------------
    src = torch.tensor(imgs[0], device=dev)
    dst = torch.zeros_like(src)
    block = src[:ROW_BLOCK + 2]
    out = torch.empty((ROW_BLOCK, SIZE), device=dev)
    nbytes = ((ROW_BLOCK + 2) * (SIZE + 2) + ROW_BLOCK * SIZE) * 4
    records = []
    for kind in ("median", "gaussian"):
        def kernel_image():
            for r in range(n_rb):
                K.blur_rows(src, dst, r * ROW_BLOCK, ROW_BLOCK, kind)

        def plain_image():
            for r in range(n_rb):
                row0 = r * ROW_BLOCK
                dst[row0 + 1:row0 + ROW_BLOCK + 1, 1:SIZE + 1] = \
                    R.blur_block(src[row0:row0 + ROW_BLOCK + 2], kind)

        hot_ms = cuda_time_ms(lambda: K.launch(block, out, kind), reps=200)
        wall_ms = {"kernel": cuda_time_ms(kernel_image, reps=5),
                "plain": cuda_time_ms(plain_image, reps=3)}
        dev_ms = {"kernel": device_ms(kernel_image),
               "plain": device_ms(plain_image)}
        ops = OPS_PER_PIXEL[kind] * ROW_BLOCK * SIZE
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        if kind == "gaussian":
            weight = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                                  device=dev).div(16.0).view(1, 1, 3, 3)

            def conv_image():
                for r in range(n_rb):
                    row0 = r * ROW_BLOCK
                    dst[row0 + 1:row0 + ROW_BLOCK + 1, 1:SIZE + 1] = F.conv2d(
                        src[None, None, row0:row0 + ROW_BLOCK + 2], weight)[0, 0]

            conv_err = float((F.conv2d(block[None, None], weight)[0, 0]
                              - K.blur_block(block, kind)).abs().max())
            wall_ms["library"] = cuda_time_ms(conv_image, reps=3)
            dev_ms["library"] = device_ms(conv_image)
            log(f"[time] gaussian conv2d (max diff vs kernel {conv_err:.3e})")
        for arm in list(dev_ms):
            if dev_ms[arm] <= 0.0:
                log(f"[time] {kind} {arm}: profiler saw no device time; "
                    f"using the CUDA-event time")
                dev_ms[arm] = wall_ms[arm]
        for arm in dev_ms:
            log(f"[time] {kind} {arm}: device {dev_ms[arm] / n_rb:.6f} ms per "
                f"row block, {dev_ms[arm]:.6f} ms per image; wall (CUDA events,"
                f" back-to-back) {wall_ms[arm] / n_rb:.6f} ms per row block, "
                f"{wall_ms[arm]:.6f} ms per image")
        rec = {"name": f"blur_{kind}", "route": "cuda",
               "source": "src/repro_torch/csrc/blur.cu",
               "replaces": REPLACES[kind],
               "launches": launches[kind],
               "max_abs_err": errs[kind],
               "ms": dev_ms["kernel"] / n_rb,
               "plain_ms": dev_ms["plain"] / n_rb,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": (dev_ms["library"] / n_rb
                              if "library" in dev_ms else None)}
        records.append(rec)
        log(f"[time] {kind}: kernel {rec['ms']:.6f} ms device per launch "
            f"(L2-hot wall {hot_ms:.6f} ms); bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']})")

    e2e = serve(imgs, 0.0)
    log_serve("e2e, no slowdown", *e2e[:4], 0.0)
    # the copies every task pays outside its chunks: the fresh upload of its
    # two images and the result copy back, both from pageable host memory
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = [torch.as_tensor(b).to(dev, copy=True)
               for b in (imgs[0], np.zeros_like(imgs[0]))]
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _ = [b.cpu().numpy() for b in on_card]
    down_ms = (time.perf_counter() - t0) * 1e3
    mb = 2 * imgs[0].nbytes / 1e6
    log(f"[copies] one task's two images ({mb:.1f} MB, pageable host "
        f"memory): upload {up_ms:.3f} ms ({mb / up_ms:.3f} GB/s), result "
        f"copy {down_ms:.3f} ms ({mb / down_ms:.3f} GB/s); kernel device "
        f"time per 3-iteration task {records[0]['ms'] * 3 * n_rb:.3f} ms")

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
