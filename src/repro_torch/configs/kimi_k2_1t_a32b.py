"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table config)
[arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, kv_heads=8, d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, sharding_profile="xxl",
    block_pattern=("attn",),
    source="arXiv:2501.kimi2 (paper-table trillion-param MoE)",
)
