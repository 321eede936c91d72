"""AdamW with fp32 master weights: the port of the reference's
``repro/optim/adamw.py``.

The optimizer state is (master, m, v), trees shaped like the params.  The
update math is f32 whatever the storage dtype: m and v are stored in
``state_dtype`` and the compute params are cast back to their own dtype.
``adamw_update`` writes every leaf in place under ``torch.no_grad()`` (the
counterpart of the reference's donated train-step buffers) and returns the
same trees.  The reference's per-leaf ``optimization_barrier`` only orders
XLA's schedule, to cap the optimizer's temporaries at one leaf's working
set; in eager PyTorch the leaves are updated one after another anyway, so
it has no counterpart.  The reference's ZeRO-1 sharding has no meaning on
one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.utils._pytree as pytree

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # the name of a torch dtype: "bfloat16" halves m/v memory
    # (memory-efficient Adam).  Update math is always f32; only storage is
    # cast.
    state_dtype: str = "float32"

    @property
    def state_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.state_dtype)


def schedule(step: torch.Tensor, opt: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - opt.warmup_steps)
                    / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.min_lr_frac + (1 - opt.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return opt.lr * warm * cos


def adamw_init(params: PyTree, opt: AdamWConfig = None):
    """(master, m, v).  The master is a copy even of f32 params: params and
    master are updated as separate buffers."""
    sd = opt.state_torch_dtype if opt is not None else torch.float32
    master = pytree.tree_map(
        lambda p: p.detach().to(torch.float32, copy=True), params)
    m = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=sd), params)
    v = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=sd), params)
    return master, m, v


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in pytree.tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, params, master, m, v, step, opt: AdamWConfig):
    """One AdamW step with global-norm clipping.  Writes ``params``,
    ``master``, ``m`` and ``v`` in place and returns them."""
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = torch.as_tensor(step)
    lr = schedule(step, opt)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(opt.b1, t)
    bc2 = 1 - torch.pow(opt.b2, t)
    sd = opt.state_torch_dtype
    flat_g, spec = pytree.tree_flatten(grads)
    flat_p = pytree.tree_leaves(params)
    flat_pm = pytree.tree_leaves(master)
    flat_m = pytree.tree_leaves(m)
    flat_v = pytree.tree_leaves(v)
    for g, p, pm, m_, v_ in zip(flat_g, flat_p, flat_pm, flat_m, flat_v):
        g = g.to(torch.float32) * scale
        m2 = opt.b1 * m_.to(torch.float32) + (1 - opt.b1) * g
        v2 = opt.b2 * v_.to(torch.float32) + (1 - opt.b2) * torch.square(g)
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + opt.eps)
        pm.copy_(pm - lr * (update + opt.weight_decay * pm))
        m_.copy_(m2.to(sd))
        v_.copy_(v2.to(sd))
        p.copy_(pm.to(p.dtype))  # compute params follow their own dtype
    return params, master, m, v
