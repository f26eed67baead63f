"""Mixture-of-Experts MLP: top-k routing, capacity-bounded dispatch, the
optional dense-residual branch (arctic) (the JAX package's
``models/moe.py``).

Two dispatch implementations (``cfg.moe_impl``), both dropping the same
tokens at capacity:
  * 'einsum' — one-hot dispatch/combine einsums over
    (groups, tokens, experts, capacity).
  * 'gather' — tokens scattered by slot into (groups, experts, capacity, d)
    buffers, combined by a gather.
``_group_count`` keeps the JAX package's data-parallel factor: the global
batch splits into ``dp * moe_groups_per_dp`` groups (halved until they
divide it), of which each data rank holds its own.

Over a 'model' axis the experts are split (expert parallelism, the JAX
package's ``moe.py:40-68``): routing runs whole on every rank, each rank
dispatches to and runs only its own experts, and the combine, contracting
over the split expert dim, ends in one all-reduce.  Where the axis does
not divide the experts, the JAX spec splits each expert's ffn dim
instead; no config of the zoo meets that layout, and ``check_mesh``
refuses it.

Routing takes ``torch.topk`` where the JAX package takes
``jax.lax.top_k``.  On equal router logits the two may order experts
differently (JAX puts the lower index first); logits drawn from
continuous weights tie with probability zero, and the parity tests assert
that their inputs hold no tie at the top-k boundary.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel import collectives as coll
from ..parallel import sharding as shd
from .common import ParamSpec


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }


def check_mesh(cfg, mesh) -> None:
    """Raise where ``mesh``'s 'model' axis would split each expert's ffn
    dim, not whole experts: the axis does not divide ``cfg.n_experts``."""
    w = moe_specs(cfg)["w_gate"]
    sl = shd.local_slice(w.logical, w.shape, mesh)
    if sl is not None and sl[0] != 0:
        raise ValueError(
            f"{cfg.name}: a model axis of {shd.model_size(mesh)} does not "
            f"divide its {cfg.n_experts} experts; expert parallelism splits "
            "whole experts")


def _capacity(tokens_per_group: int, cfg) -> int:
    cap = int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(cap, 1)


def _group_count(n_tokens: int, cfg) -> int:
    """Groups of this rank's ``n_tokens``: the JAX package's count over the
    global batch (``dp`` ranks' tokens), divided by ``dp``."""
    sizes = shd.active_mesh_shape()
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    g = dp * cfg.moe_groups_per_dp
    while g > 1 and (n_tokens * dp) % g != 0:
        g //= 2
    g = max(g, 1)
    if g % dp:
        raise ValueError(f"{cfg.name}: {g} MoE groups of {n_tokens * dp} "
                         f"tokens straddle {dp} data ranks")
    return g // dp


def _route(p, xg: torch.Tensor, cfg):
    """xg (G,T,D) -> (gate weights (G,T,k), expert ids (G,T,k))."""
    logits = (xg @ p.router).float()
    weights, ids = torch.topk(logits, cfg.top_k, dim=-1)
    weights = torch.softmax(weights, dim=-1)
    return weights.to(xg.dtype), ids


def _expert_ffn(p, inp: torch.Tensor) -> torch.Tensor:
    """inp (G,E,C,D) -> (G,E,C,D); with the experts split, this rank's
    E / M experts in and out."""
    ed = 1 if p.shard_dim("w_gate") == 0 else None
    inp = shd.constrain(inp, "act_groups", "act_experts", None, None,
                        shard=ed)
    h = F.silu(torch.einsum("gecd,edf->gecf", inp, p.w_gate))
    h = h * torch.einsum("gecd,edf->gecf", inp, p.w_up)
    h = shd.constrain(h, "act_groups", "act_experts", None, "act_ffn",
                      shard=ed)
    out = torch.einsum("gecf,efd->gecd", h, p.w_down)
    return shd.constrain(out, "act_groups", "act_experts", None, None,
                         shard=ed)


def moe_forward(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D)."""
    b, s, d = x.shape
    n_tokens = b * s
    g = _group_count(n_tokens, cfg)
    t = n_tokens // g
    cap = _capacity(t, cfg)
    xg = shd.constrain(x.reshape(g, t, d), "act_groups", None, None)
    weights, ids = _route(p, xg, cfg)
    if cfg.moe_impl == "gather":
        yg = _dispatch_gather(p, xg, weights, ids, cfg, cap)
    else:
        yg = _dispatch_einsum(p, xg, weights, ids, cfg, cap)
    return yg.reshape(b, s, d)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _positions_in_expert(ids: torch.Tensor, e: int, k: int) -> torch.Tensor:
    """(G,T,k) expert ids -> (G,T,k) position of each (token, choice) within
    its expert's capacity buffer (cumulative count order)."""
    g, t, _ = ids.shape
    flat = ids.reshape(g, t * k)
    onehot = _one_hot(flat, e, torch.int32)                       # (G, T*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1                         # (G, T*k, E)
    sel = torch.gather(pos, -1, flat[..., None])[..., 0]
    return sel.reshape(g, t, k)


def _dispatch_einsum(p, xg, weights, ids, cfg, cap):
    e, k = cfg.n_experts, cfg.top_k
    pos = _positions_in_expert(ids, e, k)                         # (G,T,k)
    keep = pos < cap                                              # capacity drop
    oe = _one_hot(ids, e, xg.dtype)                               # (G,T,k,E)
    oc = _one_hot(pos, cap, xg.dtype)                             # (G,T,k,C)
    dispatch = torch.einsum("gtke,gtkc->gtec",
                            oe * keep.to(xg.dtype)[..., None], oc)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", oe, oc,
                           weights * keep.to(weights.dtype))
    split = p.shard_dim("w_gate") == 0
    if split:           # this rank's experts: dispatch, run, combine
        dispatch = shd.constrain(dispatch, "act_groups", None, "act_experts",
                                 None)
        combine = shd.constrain(combine, "act_groups", None, "act_experts",
                                None)
        xg = coll.copy_to_model(xg)
    inp = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    out = _expert_ffn(p, inp)
    y = torch.einsum("gtec,gecd->gtd", combine, out)
    return shd.constrain(y, "act_groups", None, None, partial=split)


def _dispatch_gather(p, xg, weights, ids, cfg, cap):
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    pos = _positions_in_expert(ids, e, k)
    keep = pos < cap
    slot = torch.where(keep, ids * cap + pos, e * cap)            # overflow slot
    slot = slot.reshape(g, t * k)
    # scatter tokens into (G, E*C+1, D): each token once per choice
    xk = xg.repeat_interleave(k, dim=1)                           # (G, T*k, D)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype, device=xg.device)
    buf.scatter_add_(1, slot[..., None].expand(g, t * k, d), xk)
    inp = buf[:, :e * cap].reshape(g, e, cap, d)
    split = p.shard_dim("w_gate") == 0
    if split:           # this rank's experts in, every expert's output out
        inp = shd.constrain(inp, "act_groups", "act_experts", None, None)
    out = _expert_ffn(p, inp)
    if split:
        out = shd.constrain(out, "act_groups", None, None, None, shard=1)
    out = out.reshape(g, e * cap, d)
    out = torch.cat([out, out.new_zeros((g, 1, d))], dim=1)
    # gather back per (token, choice) and weight
    yk = torch.gather(out, 1, slot[..., None].expand(g, t * k, d))
    yk = yk.reshape(g, t, k, d) * weights[..., None]
    return yk.sum(dim=2)
