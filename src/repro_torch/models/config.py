"""Model configuration for the architecture zoo.

One frozen dataclass covers all 10 assigned families (dense / MoE / hybrid /
SSM / enc-dec); per-arch files in ``repro_torch/configs`` instantiate it
with the exact published numbers.  ``reduced()`` derives the same-family
tiny config used by CPU tests.  A copy of the JAX package's
``models/config.py`` (which imports no JAX), kept here so that the port
imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # expert hidden dim (defaults to d_ff)
    dense_residual: bool = False # arctic: dense MLP in parallel with MoE
    moe_every: int = 1           # MoE MLP on layers with i % moe_every == moe_every-1
    moe_groups_per_dp: int = 8   # dispatch groups per data shard
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"     # einsum | gather  (dispatch implementation)
    # --- attention ---
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_block_q: int = 512      # q-block size for chunked attention
    force_kv_seq_attn: bool = False  # use split-KV sharding even when heads divide
    # --- hybrid / ssm ---
    ssm: bool = False            # pure-SSM stack (attention-free)
    superblock: int = 0          # hybrid: scan unit of this many layers
    attn_every: int = 0          # hybrid: attention at i % attn_every == attn_offset
    attn_offset: int = 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- encoder-decoder (audio) ---
    encdec: bool = False
    n_enc_layers: int = 0
    frontend_dim: int = 0        # stubbed modality frontend embedding dim
    # --- numerics / memory ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for >=100B models (HBM budget)
    remat: bool = True
    train_microbatches: int = 1  # grad-accumulation chunks (activation HBM / n)
    unroll_stack: bool = False   # Python-loop the unit stack instead of scan
                                 # (analysis variants: exposes per-layer cost)
    # --- notes ---
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i."""
        if self.ssm:
            return "ssm"
        if self.attn_every:
            return "attn" if i % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def mlp_kind(self, i: int) -> str:
        """'moe' or 'dense' for layer i."""
        if self.is_moe and (i % self.moe_every == self.moe_every - 1):
            return "moe"
        return "dense"

    def has_subquadratic_decode(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid archs)."""
        return self.ssm or self.attn_every > 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        n_layers = max(2, (self.superblock or 2))
        if self.superblock:
            n_layers = self.superblock  # one superblock
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128,
            moe_d_ff=64 if self.is_moe else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=256,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if (self.ssm or self.attn_every) else self.ssm_headdim,
            ssm_chunk=8,
            attn_block_q=16,
            frontend_dim=32 if self.frontend_dim else 0,
            moe_groups_per_dp=1,
            capacity_factor=8.0,  # no capacity drops: decode == forward exactly
            opt_state_dtype="float32",
            dtype="float32",  # CPU smoke tests compare prefill/decode paths
        )

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs and HBM budgeting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d       # q,k,v,o
        dense_mlp = 3 * d * f
        moe_mlp = self.n_experts * 3 * d * self.expert_d_ff + d * self.n_experts
        ssm = 0
        if self.ssm or self.attn_every:
            di, ns, g = self.d_inner, self.ssm_state, self.ssm_groups
            nh = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * ns + nh)
            ssm = in_proj + di * d + (di + 2 * g * ns) * self.conv_width + 3 * nh + di

        total = 0
        n_stack = self.n_layers + (self.n_enc_layers if self.encdec else 0)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            total += attn if kind == "attn" else ssm
            mk = self.mlp_kind(i)
            if mk == "moe":
                total += moe_mlp + (dense_mlp if self.dense_residual else 0)
            else:
                total += dense_mlp
            total += 2 * d  # norms
        if self.encdec:
            for _ in range(self.n_enc_layers):
                total += attn + dense_mlp + 2 * d
            total += self.n_layers * (attn + d)  # cross-attention + norm
        total += v * d  # embedding
        total += v * d  # lm head (untied)
        total += d
        return total

    def n_active_params(self) -> int:
        """Active (per-token) params — MoE uses top_k of n_experts."""
        if not self.is_moe:
            return self.n_params()
        full = self.n_params()
        d = self.d_model
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.mlp_kind(i) == "moe")
        per_layer_all = self.n_experts * 3 * d * self.expert_d_ff
        per_layer_active = self.top_k * 3 * d * self.expert_d_ff
        return full - n_moe_layers * (per_layer_all - per_layer_active)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
