"""mistral-nemo-12b — dense GQA, 128k context (rope theta 1e6).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e6,
    force_kv_seq_attn=True,  # adopted: EXPERIMENTS.md §Perf iters 4-5
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
