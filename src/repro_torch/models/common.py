"""Shared model machinery: spec-driven parameters, norms, RoPE, embeddings.

Parameters are declared as ``ParamSpec`` trees (shape + logical axes +
init), as in the JAX package's ``models/common.py``.  One tree yields the
parameter count without allocating anything (``param_count``) and the
``nn.Module`` tree that holds the real parameters (``ParamModule``).  The
logical axes feed ``parallel/sharding.py``: ``Model.shardings`` turns them
into DTensor placements (``named_specs`` pairs each parameter with its
spec).

The functions here and in the sibling modules take a ``ParamModule`` where
the JAX package takes a params dict, and read its parameters as attributes
(``p.wq`` for ``params["wq"]``).

Over a mesh whose 'model' axis is above 1 a ``ParamModule`` holds this
rank's shard of each parameter (``parallel.sharding.local_slice`` of its
logical axes: tensor and expert parallelism), and ``shard_dim(name)`` says
which dim is split; the model code runs on those shards and meets the
other ranks through ``parallel/collectives.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as coll
from ..parallel import sharding as shd


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec: shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")


def _spec_leaves(specs: Any):
    if isinstance(specs, ParamSpec):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    else:
        for v in specs:
            yield from _spec_leaves(v)


def param_count(specs: Any) -> int:
    """Elements in a spec tree (dicts and lists of ``ParamSpec``)."""
    n = 0
    for s in _spec_leaves(specs):
        k = 1
        for dim in s.shape:
            k *= dim
        n += k
    return n


class ParamModule(nn.Module):
    """The parameters of one spec dict: a ``ParamSpec`` becomes a parameter
    of that name, a dict a child ``ParamModule``, a list an
    ``nn.ModuleList`` of them.  Storage is left uninitialized; ``init_params``
    fills it.  Parameters require grad: ``Model.loss`` trains through
    autograd; the serving entry points run under ``torch.no_grad``.  Over
    ``mesh`` each parameter is this rank's shard over 'model' (see the
    module docstring); ``specs`` keep the full shapes."""

    def __init__(self, specs: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device, mesh: Any = None):
        super().__init__()
        self.specs: Dict[str, ParamSpec] = {}
        self.slices: Dict[str, Optional[Tuple[int, int, int]]] = {}
        for name, s in specs.items():
            if isinstance(s, ParamSpec):
                self.specs[name] = s
                sl = (None if mesh is None
                      else shd.local_slice(s.logical, s.shape, mesh))
                self.slices[name] = sl
                shape = list(s.shape)
                if sl is not None:
                    shape[sl[0]] = sl[2]
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device)))
            elif isinstance(s, dict):
                self.add_module(name, ParamModule(s, dtype, device, mesh))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamModule(x, dtype, device, mesh) for x in s))

    def has(self, name: str) -> bool:
        return name in self.specs or name in self._modules

    def shard_dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` split over 'model' (None where this
        rank holds all of it)."""
        sl = self.slices[name]
        return None if sl is None else sl[0]


def named_specs(root: nn.Module):
    """(``state_dict`` name, ``ParamSpec``) of every parameter under
    ``root``, in ``named_parameters`` order."""
    for prefix, mod in root.named_modules():
        if isinstance(mod, ParamModule):
            for name in mod._parameters:
                yield (f"{prefix}.{name}" if prefix else name), mod.specs[name]


def named_slices(root: nn.Module):
    """(``state_dict`` name, this rank's (dim, start, length) or None) of
    every parameter under ``root``, in ``named_parameters`` order."""
    for prefix, mod in root.named_modules():
        if isinstance(mod, ParamModule):
            for name in mod._parameters:
                yield (f"{prefix}.{name}" if prefix else name), \
                    mod.slices[name]


# float32 elements of one block of an initial draw (256 MiB)
INIT_BLOCK = 1 << 26


@torch.no_grad()
def init_params(root: nn.Module, generator: torch.Generator) -> None:
    """Fill every ``ParamModule`` parameter under ``root`` with the JAX
    package's distributions (``init_params``, ``common.py:42-55``): ``normal``
    draws N(0, 1) in float32 times ``scale``; any other random init times
    1/sqrt(fan_in); ``zeros`` and ``ones`` are constants; the draw is cast
    to the parameter's dtype.  The draws come from ``generator``, which must
    live on the parameters' device, one parameter after another in module
    order, each in blocks of whole leading rows of at most ``INIT_BLOCK``
    elements (one block when it fits).  Every rank draws every block of the
    full tensor and keeps its shard's part, so the weights are those of
    the unsharded model on any mesh, and the peak is one float32 block above
    the shard.  The distributions match the JAX package's; the numbers do
    not (``torch.Generator`` is not JAX's RNG): carry JAX weights across
    with ``repro_torch.convert.model_from_reference`` where equality
    matters."""
    for mod in root.modules():
        if not isinstance(mod, ParamModule):
            continue
        for name, s in mod.specs.items():
            t = getattr(mod, name)
            if s.init == "zeros":
                t.zero_()
            elif s.init == "ones":
                t.fill_(1)
            else:
                fan_in = s.shape[0] if len(s.shape) > 1 else 1
                std = s.scale if s.init == "normal" else fan_in ** -0.5
                _draw_into(t, s.shape, mod.slices[name], std, generator)


def _draw_into(t: torch.Tensor, shape, sl, std: float,
               generator: torch.Generator) -> None:
    """``t`` = the ``sl`` shard of N(0, std^2) draws of the full ``shape``,
    drawn block by block along dim 0."""
    row = 1
    for n in shape[1:]:
        row *= n
    rows = max(1, INIT_BLOCK // max(row, 1))
    n0 = shape[0]
    dim, start, length = sl if sl is not None else (None, 0, 0)
    for r0 in range(0, max(n0, 1), rows):      # a zero-row tensor draws once
        r1 = min(n0, r0 + rows)
        draw = torch.randn((r1 - r0,) + tuple(shape[1:]), generator=generator,
                           dtype=torch.float32, device=t.device).mul_(std)
        if dim is None:
            t[r0:r1].copy_(draw)
        elif dim == 0:
            lo, hi = max(r0, start), min(r1, start + length)
            if lo < hi:
                t[lo - start:hi - start].copy_(draw[lo - r0:hi - r0])
        else:
            t[r0:r1].copy_(draw.narrow(dim, start, length))
        del draw        # before the next draw: one float32 block live


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with a float32 *reduction* and model-dtype activations: only
    the (..., 1) variance is float32, as in the JAX package."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                       # (dh/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# embeddings / unembedding (vocab padded to /256, as in the JAX package)
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> Dict[str, ParamSpec]:
    vpad = round_up(cfg.vocab_size, 256)
    return {
        "tok_embed": ParamSpec((vpad, cfg.d_model), ("vocab_in", "embed_tbl")),
        "lm_head": ParamSpec((cfg.d_model, vpad), ("embed", "vocab_out")),
        "final_norm": ParamSpec((cfg.d_model,), ("norm",), init="ones"),
    }


def embed_tokens(p, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D).  The table's columns may be split over
    'model': the lookup is local and an all-gather joins the d dim (the
    sequence stays replicated: ``act_seq``)."""
    emb = F.embedding(tokens, p.tok_embed)
    split = p.shard_dim("tok_embed") is not None
    return shd.constrain(emb, "act_batch", "act_seq", "act_embed",
                         shard=2 if split else None)


def lm_logits(p, x: torch.Tensor, cfg, gather: bool = True) -> torch.Tensor:
    """(B, S, D) -> (B, S, Vpad); the padded tail is live: readers take
    ``[..., :cfg.vocab_size]``.  With the head's vocab split over 'model'
    and ``gather=False``, this rank's vocab slice (for
    ``softmax_xent(..., vocab_start=)``)."""
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    if p.shard_dim("lm_head") is None:
        return x @ p.lm_head
    logits = coll.copy_to_model(x) @ p.lm_head
    return shd.constrain(logits, "act_batch", None,
                         "act_vocab" if not gather else None, shard=2)


def vocab_start(p) -> Optional[int]:
    """The first vocab entry of this rank's slice of ``lm_head``; None
    where the head is whole."""
    sl = p.slices["lm_head"]
    return None if sl is None else sl[1]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int,
                 vocab_start: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy; padded vocab tail masked out.  Float32
    from the cast on, as in the JAX package; its backward is autograd's
    (about three float32 copies of the logits live at its peak).

    ``vocab_start``: ``logits`` are this rank's slice of the vocab from
    that entry on (a vocab split over 'model'): the max and the sum of
    exps are all-reduced, and the target logit comes from the rank that
    holds it."""
    logits = logits.float()
    vloc = logits.shape[-1]
    v0 = vocab_start or 0
    if v0 + vloc > vocab_size:
        col = torch.arange(v0, v0 + vloc, device=logits.device)
        logits = logits + torch.where(col < vocab_size, 0.0, -1e30)
    labels = labels.long()
    if vocab_start is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(lse - gold)
    mx = coll.all_reduce(logits.detach().amax(dim=-1, keepdim=True),
                         op=torch.distributed.ReduceOp.MAX)
    sumexp = coll.reduce_from_model(torch.exp(logits - mx).sum(dim=-1))
    lse = torch.log(sumexp) + mx[..., 0]
    local = labels - v0
    mine = (local >= 0) & (local < vloc)
    picked = torch.gather(logits, -1, local.clamp(0, vloc - 1)[..., None])
    gold = coll.reduce_from_model(torch.where(mine, picked[..., 0], 0.0))
    return torch.mean(lse - gold)
