"""H2O-Danube3-4B — llama+mistral mix, GQA + sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,  # GQA
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,  # 3840/32; padded to 128 inside the Pallas kernels
    sliding_window=4096,
    rope_theta=10000.0,
    block_pattern=("attn_swa",),
    notes="SWA bounds the KV cache -> long_500k runs; head_dim 120 is not "
          "MXU-aligned, kernels pad the head dim to 128",
))
