"""End-to-end training driver: the port of the reference's
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 50 --reduced --device cpu --ckpt /path/to/ck

It runs on ``cuda:0`` unless ``--device`` names another device, and
raises without CUDA unless ``--device cpu``.  The driver integrates the
substrate end to end: the synthetic data pipeline (resumable cursor),
AdamW with f32 master weights, async double-buffered disk checkpoints
(``ckpt/store.py``, the reference's byte format), and preemption-safe
restart: run it again with the same ``--ckpt`` and it resumes the data
cursor and the optimizer state from the newest valid commit, also one the
reference wrote.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.ckpt.store import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.core.shell import resolve_devices
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.convert import _to_tensor
from repro_torch.models.lm import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig


def _assign(dst, src):
    """Copy the restored tree ``src`` (numpy leaves) into the tensors of
    ``dst`` in place, leaf for leaf."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _assign(d, s)
    else:
        t = _to_tensor(src, dst.device)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {tuple(t.shape)} does not "
                             f"match the state's {tuple(dst.shape)}")
        dst.copy_(t)


def train_loop(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
               ckpt_base: str = None, ckpt_every: int = 20, lr: float = 3e-4,
               quiet: bool = False, seed: int = 0, device=None,
               on_step: Optional[Callable[[int, dict], None]] = None):
    """Train ``cfg`` in f32 for ``steps`` steps on ``device`` (``cuda:0``
    by default).  With ``ckpt_base`` the state is committed every
    ``ckpt_every`` steps and at the end, and a run resumes from the newest
    valid commit.  ``on_step(step, metrics)`` is called after each step,
    once its loss has been read back to the host and its checkpoint
    submitted; an exception it raises ends the run as a crash would.
    Returns (state, losses)."""
    device = resolve_devices(None if device is None else [device])[0]
    opt = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                      total_steps=steps)
    data = SyntheticTokens(DataConfig(seed=1234, vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=batch))
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(cfg, opt, generator=gen, device=device,
                             param_dtype=torch.float32)
    start_step = 0

    ck = None
    if ckpt_base:
        ck = AsyncCheckpointer(ckpt_base)
        restored, meta = ck.db.restore(state)
        if restored is not None:
            with torch.no_grad():
                _assign(state, restored)
            start_step = int(meta.get("step", 0))
            if not quiet:
                print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt, remat="full", q_chunk=64)
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            state, metrics = step_fn(state, data.batch(step))
            loss = float(metrics["loss"])
            losses.append(loss)
            if not quiet and (step % max(steps // 10, 1) == 0
                              or step == steps - 1):
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({(time.time() - t0):.1f}s)")
            if ck and (step + 1) % ckpt_every == 0:
                ck.submit(state, meta={"step": step + 1})
            if on_step is not None:
                on_step(step, metrics)
        if ck:
            ck.submit(state, meta={"step": steps})
    finally:
        if ck:  # an exception still lets the submitted commits land
            ck.drain()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, ckpt_base=args.ckpt, lr=args.lr,
                           device=args.device)
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {len(losses)} steps")
    else:
        print("[train] checkpoint already at target step; nothing to do")


if __name__ == "__main__":
    main()
