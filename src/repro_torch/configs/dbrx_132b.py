"""DBRX-132B — fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,  # GQA
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=4),
    rope_theta=500000.0,
    block_pattern=("attn",),
    notes="fine-grained MoE; full global attention -> long_500k skipped",
))
