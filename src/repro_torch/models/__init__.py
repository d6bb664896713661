"""Model zoo: the reference's block-stack model for every family (dense,
local:global, MoE, xLSTM, RG-LRU hybrid, vlm, audio), training and serving
paths - see transformer.py."""
from repro_torch.models import attention, moe, recurrent, transformer
from repro_torch.models.transformer import (
    decode_step, encode_audio, forward, init_cache, init_params, loss_fn,
    prefill, prefill_chunk,
)
