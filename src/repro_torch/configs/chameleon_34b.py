"""chameleon-34b — early-fusion VLM; VQ image tokens live in the 65536 vocab,
so the modality frontend stub is the token stream itself.  Uses qk-norm
(per the Chameleon paper's training-stability recipe).
[arXiv:2405.09818; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=65536, qk_norm=True,
    force_kv_seq_attn=True,  # adopted: EXPERIMENTS.md §Perf iters 4-5
    source="arXiv:2405.09818",
)
