"""RecurrentGemma 2B — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427 (Griffin)]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, kv_heads=1, d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    native_subquadratic=True,
    source="arXiv:2402.19427",
)
