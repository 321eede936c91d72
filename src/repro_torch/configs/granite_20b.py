"""Granite-20B (code) — llama-arch dense, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10000.0,
    block_pattern=("attn",),
    notes="MQA: single kv head is replicated across the model axis",
))
