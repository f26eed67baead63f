"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE 16e top-2.
Superblocks of 8 layers (attention at in-block index 3), MoE every 2nd layer.
[arXiv:2403.19887; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_d_ff=24576, moe_every=2,
    force_kv_seq_attn=True,  # adopted: EXPERIMENTS.md §Perf iters 4-5
    superblock=8, attn_every=8, attn_offset=3,
    ssm_state=128, ssm_expand=2, ssm_headdim=128, ssm_groups=1, ssm_chunk=128,
    moe_groups_per_dp=16, capacity_factor=1.0,
    train_microbatches=8,
    opt_state_dtype="bfloat16",
    source="arXiv:2403.19887",
)
