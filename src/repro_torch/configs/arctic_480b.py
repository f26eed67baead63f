"""arctic-480b — 128-expert top-2 MoE + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    moe_groups_per_dp=16, capacity_factor=1.0,
    train_microbatches=4,
    opt_state_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)
