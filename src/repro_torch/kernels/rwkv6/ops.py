"""Device dispatch for the RWKV-6 recurrence: a CUDA tensor goes to the
hand-written kernel (``kernel.py``) or raises; a CPU tensor takes the plain
PyTorch version (``ref.py``).  There is no fallback between the two; only
an explicit ``plain_versions()`` block runs the plain version on the card.
The kernel records no gradient: asked to launch while autograd records and
an input requires a gradient, the wrapper raises rather than detach (the
training route takes the model's chunked form instead).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.native import (no_grad_kernel,  # noqa: F401
                                       plain_versions, use_kernel)
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ref as R


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          logw: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,logw: [B,T,H,hd]; u: [H,hd]; s0: [B,H,hd,hd] or None (zeros).
    Returns (o [B,T,H,hd] f32, s_last [B,H,hd,hd] f32)."""
    if use_kernel(r):
        no_grad_kernel("rwkv6", r, k, v, logw, u, s0)
        return K.launch(r, k, v, logw, u, s0)
    return R.rwkv6(r, k, v, logw, u, s0)
