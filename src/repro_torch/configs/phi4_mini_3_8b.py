"""Phi-4-mini-3.8B — dense, RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,  # GQA
    d_ff=8192,
    vocab_size=200064,  # padded to 200192 internally
    head_dim=128,
    rope_theta=10000.0,
    block_pattern=("attn",),
))
