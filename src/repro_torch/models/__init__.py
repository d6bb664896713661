"""Model zoo, the dense attention families (dense / local:global) of the
reference's block-stack model - see transformer.py for what is ported."""
from repro_torch.models import attention, transformer
from repro_torch.models.transformer import (
    decode_step, forward, init_cache, init_params, loss_fn, prefill,
    prefill_chunk,
)
