"""LM heads: the loss, the train step and the serving steps; the port of
the reference's ``repro/models/lm.py``.

Each factory returns a function with the reference's uniform signature
(state, batch) -> (state, metrics), so any architecture can occupy any
region.  The loss takes the recurrences' differentiable training route
(``forward(..., chunked=True)``): the hand-written B4/B5 kernels record no
gradient and serve only.  ``mesh`` (``sharding.spmd.Mesh`` or a named
``DeviceMesh``) reaches the MoE FFNs.  ``grad_acc_shardings`` and
``mb_shardings`` are trees of ``NamedSharding`` that constrain the
gradient accumulator and the microbatch splits: a DTensor is redistributed
to them, a plain tensor is left as it is (``with_sharding_constraint``).
``unroll`` is not taken: the port always loops over blocks in Python.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding.spmd import (lookup_rows, reduce_partial,
                                       replicate_dim, with_sharding_constraint)

PyTree = Any
AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """logits [B,T,V] (padded vocab), labels [B,T] integer (-1 = masked).
    Returns (mean_loss, n_valid), in f32, the row max held out of the
    gradient as the reference's ``stop_gradient``."""
    logits = logits.float()
    # over a vocab-sharded DTensor the two reductions are all-reduced
    m = reduce_partial(torch.amax(logits, dim=-1, keepdim=True)).detach()
    shifted = logits - m
    lse = torch.log(reduce_partial(torch.sum(torch.exp(shifted), dim=-1))) \
        + m[..., 0]
    labels = labels.long()
    idx = labels.clamp(min=0)

    def pick(t, i):
        return torch.gather(t, -1, i[..., None])[..., 0]

    picked = lookup_rows(shifted, idx, pick, -1)
    if picked is None:
        picked = pick(shifted, idx)
    ll = picked + m[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1.0)
    return nll.sum() / n, n


def init_train_state(cfg: ModelConfig, opt: AdamWConfig, *,
                     generator: Optional[torch.Generator], device,
                     param_dtype=torch.bfloat16) -> PyTree:
    """{"params", "master", "m", "v", "step"}: the params drawn from
    ``generator`` on ``device``, ``step`` an int32 0-d tensor."""
    params = TF.init_params(cfg, generator=generator, device=device,
                            dtype=param_dtype)
    master, m, v = adamw_init(params, opt)
    return {"params": params, "master": master, "m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_train_state(cfg: ModelConfig, opt: AdamWConfig,
                         param_dtype=torch.bfloat16) -> PyTree:
    """The train state on the ``meta`` device (shapes and dtypes only)."""
    return init_train_state(cfg, opt, generator=None, device="meta",
                            param_dtype=param_dtype)


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(cfg: ModelConfig, mesh=None, remat: str = "full",
                 q_chunk: int = 1024):
    """loss_fn(params, batch) -> (total, {"loss", "aux", "n_tokens"}).
    The batch holds ``tokens``, ``labels`` and, for a model with a
    frontend, ``frontend``."""
    def loss_fn(params, batch):
        batch = _on(batch, params["embed"].device)
        logits, _, aux = TF.forward(params, batch["tokens"], cfg, mesh=mesh,
                                    frontend_embeds=batch.get("frontend"),
                                    remat=remat, q_chunk=q_chunk,
                                    chunked=True)
        # frontend tokens prepended: their positions carry no labels
        labels = batch["labels"]
        if labels.shape[1] < logits.shape[1]:
            labels = F.pad(labels, (logits.shape[1] - labels.shape[1], 0),
                           value=-1)
        loss, n = cross_entropy(logits, labels)
        total = loss + AUX_WEIGHT * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n}
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh=None,
                    remat: str = "full", microbatches: int = 1,
                    q_chunk: int = 1024, grad_compression=None,
                    grad_acc_shardings=None, acc_dtype=torch.float32,
                    mb_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 accumulates the gradient (in ``acc_dtype``) over
    that many splits of the batch's leading dim, in order; the batch is
    viewed as [microbatches, B/microbatches, ...] under ``mb_shardings``
    and each split's gradients under ``grad_acc_shardings`` (the ZeRO-1
    optimizer-state layout) before they are accumulated.
    ``grad_compression`` is an optional (compress, decompress) pair applied
    to the accumulated gradient (``optim/compression.py``).  The state's
    params, master, m and v are updated in place; the returned state holds
    them and a new ``step``."""
    loss_fn = make_loss_fn(cfg, mesh=mesh, remat=remat, q_chunk=q_chunk)

    def constrain(tree, shardings):
        if shardings is None:
            return tree
        return pytree.tree_map(with_sharding_constraint, tree, shardings)

    def grad_fn(params, batch):
        flat, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        with torch.enable_grad():
            total, metrics = loss_fn(pytree.tree_unflatten(leaves, spec),
                                     batch)
            # a leaf the loss never reads (RWKV's output gate, computed and
            # not applied, as in the reference) gets a zero gradient
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, pytree.tree_unflatten(list(grads), spec)

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            metrics, grads = grad_fn(params, batch)
            grads = constrain(pytree.tree_map(lambda g: g.to(torch.float32),
                                              grads), grad_acc_shardings)
        else:
            def split(x):
                # a DTensor batch is gathered over its rows, viewed as
                # microbatches and cut by ``mb_shardings`` again
                x = replicate_dim(torch.as_tensor(x), 0)
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            mbs = constrain({k: split(v) for k, v in batch.items()},
                            mb_shardings)
            # zeros_like: a DTensor parameter's accumulator is sharded too
            grads = constrain(pytree.tree_map(
                lambda p: torch.zeros_like(p, dtype=acc_dtype), params),
                grad_acc_shardings)
            dev = params["embed"].device
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("loss", "aux", "n_tokens")}
            for i in range(microbatches):
                m_i, g_i = grad_fn(params, {k: v[i] for k, v in mbs.items()})
                g_i = constrain(pytree.tree_map(lambda g: g.to(acc_dtype),
                                                g_i), grad_acc_shardings)
                grads = pytree.tree_map(torch.add, grads, g_i)
                metrics = {k: metrics[k] + m_i[k] / microbatches
                           for k in metrics}
            grads = pytree.tree_map(
                lambda g: g.to(torch.float32) / microbatches, grads)

        if grad_compression is not None:
            compress, decompress = grad_compression
            grads = decompress(compress(grads))

        new_params, new_master, new_m, new_v = adamw_update(
            grads, state["params"], state["master"], state["m"], state["v"],
            state["step"], opt)
        new_state = {"params": new_params, "master": new_master,
                     "m": new_m, "v": new_v, "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None, q_chunk: int = 1024):
    """prefill(params, batch) -> (cache, last_logits [B,V]); the batch's
    ``frontend`` (patch embeddings or audio frames), where it has one,
    goes to ``forward``."""
    def prefill(params, batch):
        logits, cache, _ = TF.forward(params, batch["tokens"], cfg,
                                      mesh=mesh,
                                      frontend_embeds=batch.get("frontend"),
                                      want_cache=True, q_chunk=q_chunk,
                                      last_only=True)
        return cache, logits[:, -1, :]
    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None, greedy: bool = True):
    """serve_step(params, cache, token, generator=None) -> (next_token
    [B,1] int32, cache).  Greedy takes the first maximal logit, as
    ``jnp.argmax``; otherwise the token is drawn from the softmax of the
    logits with ``generator`` (required), the counterpart of
    ``jax.random.categorical``.  The cache is updated in place."""
    def serve_step(params, cache, token,
                   generator: Optional[torch.Generator] = None):
        logits, cache = TF.decode_step(params, cache, token, cfg, mesh=mesh)
        # a vocab-sharded DTensor is gathered before it is cut and reduced
        logits = replicate_dim(logits, 2)[:, 0, :cfg.vocab_size].float()
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            if generator is None:
                raise ValueError("sampling needs an explicit generator")
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=generator)[:, 0]
        return nxt.to(torch.int32)[:, None], cache
    return serve_step
