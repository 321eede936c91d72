"""Qwen3-8B — dense, GQA, qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,  # GQA
    d_ff=12288,
    vocab_size=151936,  # padded to 152064 internally
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    block_pattern=("attn",),
))
