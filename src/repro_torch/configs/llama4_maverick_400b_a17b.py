"""llama4-maverick-400b-a17b — top-1 routed MoE, early fusion, 202k vocab.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048,
    n_experts=128, top_k=1, moe_d_ff=8192,
    moe_groups_per_dp=16, capacity_factor=1.0,
    opt_state_dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
