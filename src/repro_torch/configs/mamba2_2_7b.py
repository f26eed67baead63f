"""mamba2-2.7b — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50280,
    ssm=True, ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    source="arXiv:2405.21060",
)
