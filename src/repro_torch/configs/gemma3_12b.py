"""Gemma 3 12B — 5 local (sliding-window 1024) : 1 global attention, 128k
context [hf:google/gemma-3-1b-pt family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, kv_heads=8, d_ff=15360, vocab=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, native_subquadratic=True, rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt (scaled per assignment)",
)
