"""Mixtral-8x22B — MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,  # GQA
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    rope_theta=1000000.0,
    block_pattern=("attn_swa",),
    notes="SWA bounds the KV cache -> long_500k runs",
))
