"""Whisper tiny — encoder-decoder; conv/mel frontend stubbed to frame
embeddings per spec [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, kv_heads=6, d_ff=1536, vocab=51865,
    encoder_layers=4, n_audio_frames=1500, mlp_type="gelu",
    block_pattern=("attn",),
    source="arXiv:2212.04356",
)
