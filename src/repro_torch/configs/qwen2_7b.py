"""Qwen2 7B — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, kv_heads=4, d_ff=18944, vocab=152064,
    qkv_bias=True, block_pattern=("attn",), rope_theta=1e6,
    source="arXiv:2407.10671",
)
