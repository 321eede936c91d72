"""input_specs(): ``meta``-device stand-ins for every model input of every
(arch x shape) cell, plus the matching shardings -- no device allocation;
the port of the reference's ``repro/launch/specs.py``.

The uniform step signatures (the paper's interface-conformance requirement):
    train:          step(state, batch)                  -> (state, metrics)
    prefill:        step(params, batch)                 -> (cache, last_logits)
    decode/serving: step(params, cache, token, generator) -> (token, cache)

Where the reference's decode cell holds an abstract PRNG key, the port's
holds ``None``: its decode step takes an optional ``torch.Generator``
(greedy decoding needs none), and no generator lives on ``meta``.  The
cache's ``pos`` is the port's host int.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm as LM
from repro_torch.models import transformer as TF
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import rules as R
from repro_torch.sharding.spmd import P, mesh_shape

PyTree = Any


def cell_opt(cfg: ModelConfig) -> AdamWConfig:
    """Optimizer config for a cell: bf16 m/v for the >=100B configs, as the
    reference chose for its 16 GB/chip pod."""
    if cfg.param_count() > 6e10:
        return AdamWConfig(state_dtype="bfloat16")
    return AdamWConfig()


def sds(shape, dtype) -> torch.Tensor:
    """The ``ShapeDtypeStruct`` counterpart: a tensor on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_structs(cfg: ModelConfig, shape: ShapeConfig,
                  compute_dtype=torch.bfloat16) -> dict:
    """Abstract batch for train/prefill shapes."""
    B, T = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "vision":
        nf = cfg.n_frontend_tokens
        batch["tokens"] = sds((B, T - nf), torch.int32)
        batch["labels"] = sds((B, T - nf), torch.int32)
        batch["frontend"] = sds((B, nf, cfg.d_model), compute_dtype)
    elif cfg.frontend == "audio":
        batch["tokens"] = sds((B, T), torch.int32)
        batch["labels"] = sds((B, T), torch.int32)
        batch["frontend"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                compute_dtype)
    else:
        batch["tokens"] = sds((B, T), torch.int32)
        batch["labels"] = sds((B, T), torch.int32)
    if shape.kind == "prefill":
        batch.pop("labels")
    return batch


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   dtype=torch.bfloat16) -> PyTree:
    return TF.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta", dtype=dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                opt: Optional[AdamWConfig] = None,
                param_dtype=torch.bfloat16) -> tuple:
    """The cell's step arguments, as abstract trees on ``meta``."""
    opt = opt or cell_opt(cfg)
    if shape.kind == "train":
        state = LM.abstract_train_state(cfg, opt, param_dtype)
        return (state, batch_structs(cfg, shape))
    params = TF.abstract_params(cfg, param_dtype)
    if shape.kind == "prefill":
        return (params, batch_structs(cfg, shape))
    # decode / long_decode
    cache = abstract_cache(cfg, shape, dtype=param_dtype)
    token = sds((shape.global_batch, 1), torch.int32)
    return (params, cache, token, None)


def _wrap(mesh, tree):
    return pytree.tree_map(lambda spec: R.named(mesh, spec), tree,
                           is_leaf=lambda x: isinstance(x, P))


def _all_axes_batch(mesh, batch) -> dict:
    """FSDP: the batch's leading dim over every mesh axis."""
    axes = tuple(mesh_shape(mesh))
    return pytree.tree_map(lambda leaf: P(axes, *([None] * (leaf.dim() - 1))),
                           batch)


def _fsdp_state(cfg, mesh, params) -> dict:
    p_specs = R.param_specs(cfg, mesh, params, mode="fsdp")
    return {"params": p_specs, "master": p_specs, "m": p_specs,
            "v": p_specs, "step": P()}


def _dp_size(mesh) -> int:
    return math.prod(mesh_shape(mesh)[a] for a in R.data_axes(mesh))


def _token_spec(shape: ShapeConfig, mesh) -> P:
    dp = R.data_axes(mesh)
    return P(dp if shape.global_batch % _dp_size(mesh) == 0 else None, None)


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, args,
                    mode: str = "tp") -> tuple:
    """``NamedSharding`` trees matching input_specs() output."""
    if shape.kind == "train":
        state, batch = args
        if mode == "fsdp":
            return (_wrap(mesh, _fsdp_state(cfg, mesh, state["params"])),
                    _wrap(mesh, _all_axes_batch(mesh, batch)))
        return (_wrap(mesh, R.train_state_specs(cfg, mesh, state)),
                _wrap(mesh, R.batch_specs(cfg, shape, mesh, batch)))
    if shape.kind == "prefill":
        params, batch = args
        if mode == "fsdp":
            return (_wrap(mesh, R.param_specs(cfg, mesh, params, mode="fsdp")),
                    _wrap(mesh, _all_axes_batch(mesh, batch)))
        return (_wrap(mesh, R.param_specs(cfg, mesh, params)),
                _wrap(mesh, R.batch_specs(cfg, shape, mesh, batch)))
    params, cache, _, _ = args
    return (_wrap(mesh, R.param_specs(cfg, mesh, params)),
            _wrap(mesh, R.cache_specs(cfg, mesh, cache)),
            R.named(mesh, _token_spec(shape, mesh)), R.named(mesh, P()))


def output_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, args,
                     mode: str = "tp"):
    """Shardings of the step's outputs (state/cache keep their input
    shardings; small outputs replicated)."""
    if shape.kind == "train":
        state, _ = args
        metrics = {k: R.named(mesh, P()) for k in ("loss", "aux", "n_tokens")}
        if mode == "fsdp":
            return (_wrap(mesh, _fsdp_state(cfg, mesh, state["params"])),
                    metrics)
        return (_wrap(mesh, R.train_state_specs(cfg, mesh, state)), metrics)
    if shape.kind == "prefill":
        cache = abstract_cache(cfg, shape)
        dp = R.data_axes(mesh)
        m = mesh_shape(mesh)["model"]
        logit_spec = P(dp if shape.global_batch % _dp_size(mesh) == 0
                       else None,
                       "model" if cfg.padded_vocab % m == 0 else None)
        return (_wrap(mesh, R.cache_specs(cfg, mesh, cache)),
                R.named(mesh, logit_spec))
    _, cache, _, _ = args
    return (R.named(mesh, _token_spec(shape, mesh)),
            _wrap(mesh, R.cache_specs(cfg, mesh, cache)))


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Enough grad-accumulation that saved layer inputs fit device memory:
    aim for ~1-2 sequences per data shard per microbatch on the big
    models."""
    if shape.kind != "train":
        return 1
    dp = _dp_size(mesh)
    b_loc = max(shape.global_batch // max(dp, 1), 1)
    big = cfg.param_count() > 3e9
    giant = cfg.param_count() > 5e9
    target = 1 if giant else (2 if big else 8)  # seqs/shard/microbatch
    mb = max(b_loc // target, 1)
    while shape.global_batch % (mb * dp) and mb > 1:
        mb -= 1
    return mb


def step_fn(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
            opt: Optional[AdamWConfig] = None, remat: str = "full",
            q_chunk: int = 1024, microbatches: Optional[int] = None):
    """The cell's step function over ``mesh``.  The reference's ``unroll``
    (the port loops over blocks) and ``moe_mode`` (a hook that sets
    nothing there; ``moe.MOE_MODE`` chooses) are not taken."""
    opt = opt or cell_opt(cfg)
    if shape.kind == "train":
        if microbatches is None:
            microbatches = default_microbatches(cfg, shape, mesh)
        state = LM.abstract_train_state(cfg, opt)
        acc = _wrap(mesh, R.train_state_specs(cfg, mesh, state)["m"])
        # >=100B models: bf16 gradient accumulation, as the reference
        acc_dtype = (torch.bfloat16 if cfg.param_count() > 6e10
                     else torch.float32)
        mb_sh = None
        if microbatches > 1:
            b_specs = R.batch_specs(cfg, shape, mesh,
                                    batch_structs(cfg, shape))
            mb_sh = pytree.tree_map(lambda spec: R.named(mesh, P(None, *spec)),
                                    b_specs, is_leaf=lambda x: isinstance(x, P))
        return LM.make_train_step(cfg, opt, mesh=mesh, remat=remat,
                                  q_chunk=q_chunk, microbatches=microbatches,
                                  grad_acc_shardings=acc, acc_dtype=acc_dtype,
                                  mb_shardings=mb_sh)
    if shape.kind == "prefill":
        return LM.make_prefill_step(cfg, mesh=mesh, q_chunk=q_chunk)
    return LM.make_decode_step(cfg, mesh=mesh)
