"""seamless-m4t-large-v2 — encoder-decoder, multimodal (speech frontend is a
stub feeding precomputed frame embeddings).  GQA kv=16 == MHA at 16 heads.
[arXiv:2308.11596; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab_size=256206,
    encdec=True, n_enc_layers=24, frontend_dim=1024,
    force_kv_seq_attn=True,  # adopted: EXPERIMENTS.md §Perf iters 4-5
    source="arXiv:2308.11596",
)
