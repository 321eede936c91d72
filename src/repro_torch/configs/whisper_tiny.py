"""Whisper-tiny — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,   # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,  # MHA
    d_ff=1536,
    vocab_size=51865,  # padded to 51968 internally
    head_dim=64,
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio",
    rope_theta=10000.0,
    block_pattern=("attn",),
    notes="enc-dec; decode shapes run (it has a decoder); long_500k skipped "
          "(full attention)",
))
