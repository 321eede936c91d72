"""LLaVA-NeXT-34B — VLM; anyres vision frontend is a STUB (input_specs
provides precomputed patch embeddings).  [hf:llava-hf/...; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,  # GQA
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    frontend="vision",
    n_frontend_tokens=576,  # one anyres tile of 24x24 patches
    rope_theta=5000000.0,
    block_pattern=("attn",),
    notes="full global attention -> long_500k skipped",
))
