#!/usr/bin/env python3
"""How many chunks M1 runs after the host writes its preempt flag, on one
NVIDIA card.  Run from the repository root:

    python3 tools/megakernel_flag_lag.py [--trials 15]

For each variant of the persistent blur kernel (``csrc/blur.cu`` as it is,
and copies of it built with ``__threadfence_system()`` after the progress
store, and also before the flag read), it launches a budget-1 median task
on a 4096^2 frame (12 iterations, 1536 chunks), samples the flag's
progress word from the host in a tight loop, writes the flag once the
progress passes a random chunk, reads the progress right after the write,
and records the chunk the launch exited at.  It prints, per variant, the
exits minus that progress, the steps in which the host saw the progress
advance, and the host wall time of a whole task.  Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STORE = "      *reinterpret_cast<volatile int*>(a.progress) = n_chunks;\n"
READ = "      const int f = load_flag(a.flag);"
FENCE = "      __threadfence_system();\n"


def variants(text: str) -> dict:
    """Source of each variant, None for the kernel as built."""
    if STORE not in text or READ not in text:
        raise RuntimeError("csrc/blur.cu no longer has the boundary code "
                           "this tool edits")
    fenced = text.replace(STORE, STORE + FENCE)
    return {"as is": None,
            "fence after progress": fenced,
            "fence before flag read": fenced.replace(READ, FENCE + READ)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=15)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag
    from repro_torch.kernels import native
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur.tasks import make_image

    native.load_libraries(("blur", "preempt_flag"))
    libs = {}
    for i, (name, body) in enumerate(
            variants((native.CSRC / "blur.cu").read_text()).items()):
        if body is None:
            libs[name] = native._libs["blur"]
            continue
        src = native.BUILD_DIR / f"blur_variant{i}.cu"
        src.write_text(body)
        out = native.BUILD_DIR / f"libblur_variant{i}.so"
        proc = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(proc.stderr)
        libs[name] = ctypes.CDLL(str(out))

    dev = torch.device("cuda", 0)
    img = make_image(np.random.default_rng(0), 4096)
    ping, pong = torch.tensor(img, device=dev), torch.zeros(img.shape,
                                                            device=dev)
    flag = PreemptFlag(dev)
    words = ContextRecord.fresh().to_words()
    rng = np.random.default_rng(1)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(out)
    for name, lib in libs.items():
        native._libs["blur"] = lib  # the wrapper binds this library
        lags, steps = [], []
        for _ in range(args.trials):
            target = int(rng.integers(200, 1200))
            flag.clear()
            launch = K.blur_mega(words, ping, pong, "median", 12, 1, flag)
            last, p_write = flag.progress(), None
            while not launch.query():
                p = flag.progress()
                if p != last:
                    steps.append(p - last)
                    last = p
                if p_write is None and p >= target:
                    flag.write(1)
                    p_write = flag.progress()
            _, n = launch.result()
            lags.append(n - p_write)
        steps = np.array(steps)
        flag.clear()
        t0 = time.perf_counter()
        for _ in range(5):
            K.blur_mega(words, ping, pong, "median", 12, 1, flag).result()
        wall_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"{name}: exit - progress read after the write {sorted(lags)}; "
              f"progress steps seen by the host: share of 1s "
              f"{np.mean(steps == 1):.3f}, largest {steps.max()}; "
              f"{wall_ms:.3f} ms host wall a 1536-chunk task", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
