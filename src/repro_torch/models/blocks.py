"""Block assembly: pre-norm residual blocks with attention or SSD mixers and
dense / MoE (+ dense-residual) MLPs, and the unit layout, including jamba's
8-layer superblocks (1 attention layer in 8) (the JAX package's
``models/blocks.py``).

The JAX package stacks each unit's parameters along a leading 'layers' axis
and scans; the port holds one ``ParamModule`` per layer in an
``nn.ModuleList`` and loops, so layer ``u * unit + i`` has the kinds of
position ``i`` of ``unit_layout``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..parallel import sharding as shd
from .attention import (attn_decode, attn_forward, attn_specs,
                        cross_attn_forward)
from .attention import init_cache as init_kv_cache
from .common import ParamSpec, rmsnorm
from .mlp import mlp_forward, mlp_specs
from .moe import moe_forward, moe_specs
from .ssm import init_state as init_ssm_state
from .ssm import ssm_forward, ssm_specs


def _norm_spec(cfg) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("norm",), init="ones")


def layer_specs(cfg, kind: str, mlp_kind: str,
                cross: bool = False) -> Dict[str, Any]:
    specs: Dict[str, Any] = {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg)}
    if kind == "attn":
        specs["attn"] = attn_specs(cfg)
    else:
        specs["ssm"] = ssm_specs(cfg)
    if mlp_kind == "moe":
        specs["moe"] = moe_specs(cfg)
        if cfg.dense_residual:
            specs["mlp"] = mlp_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    if cross:
        specs["ln_cross"] = _norm_spec(cfg)
        specs["cross"] = attn_specs(cfg, cross=True)
    return specs


def _mlp(p, h, cfg, mlp_kind: str):
    if mlp_kind == "moe":
        m = moe_forward(p.moe, h, cfg)
        if cfg.dense_residual:
            m = m + mlp_forward(p.mlp, h)
        return m
    return mlp_forward(p.mlp, h)


def layer_forward(p, x, cfg, kind: str, mlp_kind: str, positions,
                  causal: bool = True, enc_kv: Optional[Tuple] = None,
                  enc_positions=None):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if kind == "attn":
        a = attn_forward(p.attn, h, cfg, positions, causal=causal)
    else:
        a = ssm_forward(p.ssm, h, cfg)
    x = x + a
    if enc_kv is not None:
        h = rmsnorm(x, p.ln_cross, cfg.norm_eps)
        x = x + cross_attn_forward(p.cross, h, enc_kv, cfg, enc_positions)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    x = x + _mlp(p, h, cfg, mlp_kind)
    return shd.constrain(x, "act_batch", "act_seq", "act_embed")


def layer_decode(p, x, cfg, kind: str, mlp_kind: str, cache, pos: int,
                 enc_kv: Optional[Tuple] = None, enc_positions=None,
                 split: bool = False):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if kind == "attn":
        a, cache = attn_decode(p.attn, h, cache, cfg, pos, split=split)
    else:
        a, cache = ssm_forward(p.ssm, h, cfg, state=cache, pos=pos)
    x = x + a
    if enc_kv is not None:
        h = rmsnorm(x, p.ln_cross, cfg.norm_eps)
        x = x + cross_attn_forward(p.cross, h, enc_kv, cfg, enc_positions)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + _mlp(p, h, cfg, mlp_kind), cache


# ---------------------------------------------------------------------------
# units: one layer, or one superblock of layers
# ---------------------------------------------------------------------------

def unit_layout(cfg) -> Tuple[int, Tuple[Tuple[str, str], ...]]:
    """-> (n_units, ((kind, mlp_kind) per layer inside a unit))."""
    sb = cfg.superblock or (cfg.moe_every if cfg.is_moe and cfg.moe_every > 1
                            else 1)
    if cfg.n_layers % sb != 0:
        raise ValueError(f"unit_layout: {cfg.n_layers} layers do not split "
                         f"into units of {sb}")
    layout = tuple((cfg.layer_kind(i), cfg.mlp_kind(i)) for i in range(sb))
    return cfg.n_layers // sb, layout


def layer_kinds(cfg) -> List[Tuple[str, str]]:
    """(kind, mlp_kind) of every layer, unit after unit."""
    n_units, layout = unit_layout(cfg)
    return list(layout) * n_units


def stack_specs(cfg, cross: bool = False) -> List[Dict[str, Any]]:
    """One spec dict per layer (the JAX package's ``stack_unit_specs``
    without the stacking)."""
    return [layer_specs(cfg, k, m, cross=cross) for k, m in layer_kinds(cfg)]


def layer_cache(cfg, kind: str, batch: int, max_len: int, dtype, device):
    """One layer's zeroed decode state: a KV cache or an SSM state."""
    if kind == "attn":
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    return init_ssm_state(cfg, batch, dtype, device)
