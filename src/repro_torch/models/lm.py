"""LM serving steps: the port of ``make_prefill_step`` and
``make_decode_step`` from the reference's ``repro/models/lm.py``.  The loss
and the train step come with the training slice of the port."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 1024):
    """prefill(params, batch) -> (cache, last_logits [B,V])."""
    def prefill(params, batch):
        logits, cache = TF.forward(params, batch["tokens"], cfg,
                                   want_cache=True, q_chunk=q_chunk,
                                   last_only=True)
        return cache, logits[:, -1, :]
    return prefill


def make_decode_step(cfg: ModelConfig, greedy: bool = True):
    """serve_step(params, cache, token, generator=None) -> (next_token
    [B,1] int32, cache).  Greedy takes the first maximal logit, as
    ``jnp.argmax``; otherwise the token is drawn from the softmax of the
    logits with ``generator`` (required), the counterpart of
    ``jax.random.categorical``.  The cache is updated in place."""
    def serve_step(params, cache, token,
                   generator: Optional[torch.Generator] = None):
        logits, cache = TF.decode_step(params, cache, token, cfg)
        logits = logits[:, 0, :cfg.vocab_size].float()
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            if generator is None:
                raise ValueError("sampling needs an explicit generator")
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
        return nxt.to(torch.int32)[:, None], cache
    return serve_step
