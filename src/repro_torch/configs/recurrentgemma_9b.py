"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,  # MQA for the local-attention layers
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attn_local_window=2048,
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "attn_local"),
    rglru_conv_width=4,
    notes="hybrid: O(1) recurrent state + windowed attention -> long_500k runs;"
          " 38 = 12*(r,r,a) + (r,r) tail",
))
