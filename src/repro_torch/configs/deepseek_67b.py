"""DeepSeek 67B — deep llama-architecture dense model [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, kv_heads=8, d_ff=22016, vocab=102400,
    block_pattern=("attn",),
    source="arXiv:2401.02954",
)
