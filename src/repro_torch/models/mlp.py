"""Dense SwiGLU MLP (the JAX package's ``models/mlp.py``).

mamba2-2.7b has ``d_ff = 0``: its layers keep zero-width MLP weights and
this function returns zeros for them, as the JAX package's does.

Over a 'model' axis the ffn dim is split (``mlp.py:24-30`` of the JAX
package): gate and up are column-parallel, down is row-parallel, and one
all-reduce joins the partial sums (the JAX package reduce-scatters onto a
sequence-sharded stream; the port keeps the stream replicated).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .common import ParamSpec


def mlp_specs(cfg, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    x = shd.constrain(x, "act_batch", None, "act_embed")
    sharded = p.shard_dim("w_down") is not None
    # a zero-width MLP (mamba2) gives zeros on every rank: nothing to join
    split = sharded and p.w_down.numel() > 0
    if split:
        x = coll.copy_to_model(x)
    h = F.silu(x @ p.w_gate)
    h = h * (x @ p.w_up)
    h = shd.constrain(h, "act_batch", None, "act_ffn",
                      shard=2 if sharded else None)
    y = h @ p.w_down
    return shd.constrain(y, "act_batch", "act_seq", "act_embed",
                         partial=split)
