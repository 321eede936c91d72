"""Configuration system: architectures and input shapes.

Every assigned architecture is a ``ModelConfig``; every assigned input shape
is a ``ShapeConfig``.  The dry-run / launcher selects cells as
``(arch_id, shape_id)``.  Vocab sizes are padded up to a multiple of
``VOCAB_PAD`` so the vocabulary dimension always divides the model axis of the
production mesh; the true vocab is kept for metrics/decoding.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

VOCAB_PAD = 256  # lcm-friendly: divisible by model axis (16) and MXU lanes (128)


def pad_vocab(v: int) -> int:
    return int(math.ceil(v / VOCAB_PAD) * VOCAB_PAD)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (a column of the cell matrix)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


# The four assigned LM shapes (identical across all ten architectures).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture.  ``block_pattern`` composes the layer stack:

    - ``attn``        global causal self-attention
    - ``attn_swa``    sliding-window causal self-attention
    - ``attn_local``  local attention (RecurrentGemma-style window)
    - ``rglru``       RG-LRU recurrent block (RecurrentGemma)
    - ``rwkv``        RWKV-6 time-mix block (attention-free)

    The pattern tiles over ``n_layers`` (remainder layers are taken from the
    pattern prefix).  Dense/MoE FFN follows every block.
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None  # for attn_swa
    attn_local_window: Optional[int] = None  # for attn_local
    qk_norm: bool = False
    rope_theta: float = 10000.0
    block_pattern: Tuple[str, ...] = ("attn",)
    # Encoder-decoder (whisper): number of encoder layers and encoder length.
    encoder_layers: int = 0
    encoder_seq: int = 0
    # Modality frontend stubs: "audio" | "vision" | None.
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    # RWKV-6 sizing
    rwkv_head_dim: int = 64
    # RG-LRU sizing
    rglru_conv_width: int = 4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    notes: str = ""

    # -- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_c(self) -> int:
        """Compute-time query-head count, padded up to a multiple of 16 so
        attention weights shard on a 16-way model axis (padded heads carry
        zero weights and are mathematically inert; DESIGN.md §5).  Heads
        below 16 (whisper) stay unpadded and replicate instead."""
        h = self.n_heads
        if h >= 16 and h % 16 != 0:
            return ((h + 15) // 16) * 16
        return h

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: no *global* full-attention block."""
        return all(b != "attn" for b in self.block_pattern)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim_
        n = 0
        n += self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d  # unembed
        for kind in self.layer_kinds:
            if kind in ("attn", "attn_swa", "attn_local"):
                n += d * self.n_heads * hd  # wq
                n += 2 * d * self.n_kv_heads * hd  # wk, wv
                n += self.n_heads * hd * d  # wo
            elif kind == "rglru":
                lw = self.d_model
                n += 2 * d * lw + lw * d  # in-proj x2 (x & gate), out-proj
                n += self.rglru_conv_width * lw + 3 * lw  # conv + a/gate params
            elif kind == "rwkv":
                n += 6 * d * d  # r,k,v,g,w(lora approx),o
            n += self._ffn_params()
            n += 2 * d  # norms
        if self.is_encdec:
            for _ in range(self.encoder_layers):
                n += 2 * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                          + self.n_heads * hd * d)  # enc self + dec cross attn
                n += self._ffn_params()
                n += 4 * d
        return n

    def _ffn_params(self) -> int:
        if self.moe is not None:
            e = self.moe.n_experts
            return e * 3 * self.d_model * self.d_ff + self.d_model * e
        return 3 * self.d_model * self.d_ff  # SwiGLU

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e, k = self.moe.n_experts, self.moe.top_k
        ffn_all = len(self.layer_kinds) * e * 3 * self.d_model * self.d_ff
        ffn_active = len(self.layer_kinds) * k * 3 * self.d_model * self.d_ff
        return full - ffn_all + ffn_active

    def shapes(self) -> list[ShapeConfig]:
        """The assigned shapes this arch actually runs (skips documented in
        DESIGN.md §4: long_500k only for sub-quadratic stacks)."""
        out = []
        for s in SHAPES.values():
            if s.kind == "long_decode" and not self.subquadratic:
                continue
            out.append(s)
        return out

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * len(self.block_pattern)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8)
            if self.n_frontend_tokens
            else 0,
            sliding_window=16 if self.sliding_window else None,
            attn_local_window=16 if self.attn_local_window else None,
            rwkv_head_dim=32 if self.family == "ssm" else self.rwkv_head_dim,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=2,
                                  capacity_factor=self.moe.capacity_factor)
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # Late import so "import repro_torch.configs.base" has no side effects.
    from repro_torch import configs as _c  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from repro_torch import configs as _c  # noqa: F401

    return dict(_REGISTRY)
