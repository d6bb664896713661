"""IBM Granite 3.0 1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=8, d_ff=512, vocab=49155,
    n_experts=32, top_k=8,
    block_pattern=("attn",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
