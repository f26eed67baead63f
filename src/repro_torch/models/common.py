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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


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
    autograd; the serving entry points run under ``torch.no_grad``."""

    def __init__(self, specs: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.specs: Dict[str, ParamSpec] = {}
        for name, s in specs.items():
            if isinstance(s, ParamSpec):
                self.specs[name] = s
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=dtype, device=device)))
            elif isinstance(s, dict):
                self.add_module(name, ParamModule(s, dtype, device))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamModule(x, dtype, device) for x in s))

    def has(self, name: str) -> bool:
        return name in self.specs or name in self._modules


def named_specs(root: nn.Module):
    """(``state_dict`` name, ``ParamSpec``) of every parameter under
    ``root``, in ``named_parameters`` order."""
    for prefix, mod in root.named_modules():
        if isinstance(mod, ParamModule):
            for name in mod._parameters:
                yield (f"{prefix}.{name}" if prefix else name), mod.specs[name]


@torch.no_grad()
def init_params(root: nn.Module, generator: torch.Generator) -> None:
    """Fill every ``ParamModule`` parameter under ``root`` with the JAX
    package's distributions (``init_params``, ``common.py:42-55``): ``normal``
    draws N(0, 1) in float32 times ``scale``; any other random init times
    1/sqrt(fan_in); ``zeros`` and ``ones`` are constants; the draw is cast
    to the parameter's dtype.  The draws come from ``generator``, which must
    live on the parameters' device, one parameter after another in module
    order.  The distributions match the JAX package's; the numbers do not
    (``torch.Generator`` is not JAX's RNG): carry JAX weights across with
    ``repro_torch.convert.model_from_reference`` where equality matters."""
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
                draw = torch.randn(s.shape, generator=generator,
                                   dtype=torch.float32, device=t.device)
                t.copy_(draw.mul_(std))
                del draw        # before the next draw: one float32 copy live


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
    """tokens (B, S) -> (B, S, D)."""
    return F.embedding(tokens, p.tok_embed)


def lm_logits(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, D) -> (B, S, Vpad); the padded tail is live: readers take
    ``[..., :cfg.vocab_size]``."""
    x = rmsnorm(x, p.final_norm, cfg.norm_eps)
    return x @ p.lm_head


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy; padded vocab tail masked out.  Float32
    from the cast on, as in the JAX package; its backward is autograd's
    (about three float32 copies of the logits live at its peak)."""
    logits = logits.float()
    vpad = logits.shape[-1]
    if vpad != vocab_size:
        tail = torch.zeros(vpad, dtype=torch.float32, device=logits.device)
        tail[vocab_size:] = -1e30
        logits = logits + tail
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)
