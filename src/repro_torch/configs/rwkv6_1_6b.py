"""RWKV-6 'Finch' 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,       # time-mix heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_dim=64,
    block_pattern=("rwkv",),
    notes="O(1) state -> long_500k runs; channel-mix uses square-relu MLP",
))
