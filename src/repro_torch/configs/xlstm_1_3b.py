"""xLSTM 1.3B — sLSTM + mLSTM block stack [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, kv_heads=4, d_ff=0, vocab=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    native_subquadratic=True,
    source="arXiv:2405.04517 (xLSTM[5:1] block ratio, 1.3B table)",
)
