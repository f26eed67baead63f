"""Dense SwiGLU MLP (the JAX package's ``models/mlp.py``).

mamba2-2.7b has ``d_ff = 0``: its layers keep zero-width MLP weights and
this function returns zeros for them, as the JAX package's does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ParamSpec


def mlp_specs(cfg, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn")),
        "w_up": ParamSpec((d, f), ("embed", "ffn")),
        "w_down": ParamSpec((f, d), ("ffn", "embed")),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p.w_gate)
    h = h * (x @ p.w_up)
    return h @ p.w_down
