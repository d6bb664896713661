"""Llama 3.2 Vision 11B — language decoder with gated cross-attention image
layers every 5 layers; vision encoder stubbed per spec
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, kv_heads=8, d_ff=14336, vocab=128256,
    cross_attn_every=5, vis_tokens=1600,
    block_pattern=("attn",), rope_theta=5e5,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
