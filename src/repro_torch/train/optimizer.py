"""AdamW with global-norm clipping, decoupled weight decay, the warmup +
cosine schedule and gradient compression (the JAX package's
``train/optimizer.py``), in plain tensor ops.

The state is ``step`` (a 0-d int32 tensor) and the moments ``m`` and ``v``,
dicts keyed like ``Model.named_parameters()`` and held in
``cfg.state_dtype``.  The arithmetic is the JAX package's ``upd``, op for
op: float32 math, the moments rounded to ``state_dtype`` after the step,
the parameter cast back to its own dtype once, at the end.  There is no
float32 master copy, as there is none in the JAX package.  The schedule
and the bias corrections are float32 tensors on the parameters' device, so
a step reads nothing back to the host.

The port updates in place, under ``torch.no_grad``, one tensor at a time
and each in slices of ``UPDATE_CHUNK`` elements: every op is elementwise,
so the slices give the same numbers, and the float32 temporaries never
exceed a few slices (qwen3-8b's ``lm_head`` alone is 2.49 GB in float32).
``torch.optim.AdamW`` is not used: its operation order and its bf16
handling are not the JAX package's.

Under tensor parallelism (a ``Model`` over a 'model' axis) each rank holds
shards of some parameters and whole copies of the rest; the update stays
elementwise on what the rank holds, and the clip's global norm sums the
split parameters' squares over the model group and counts each whole one
once (``Model.norm_layout``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import torch

Tensors = Mapping[str, torch.Tensor]

# elements a slice of the update; 128 MiB of float32
UPDATE_CHUNK = 1 << 25


@dataclass
class AdamWState:
    step: torch.Tensor              # () int32
    m: Dict[str, torch.Tensor]      # like the parameters, in state_dtype
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"


def _params(params: Union[torch.nn.Module, Tensors]) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: Union[torch.nn.Module, Tensors],
               cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    ps = _params(params)
    dev = next(iter(ps.values())).device if ps else torch.device("cpu")
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in ps.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in ps.items()})


def abstract_state(abstract_params: Tensors, cfg: AdamWConfig) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors (no storage)."""
    dt = getattr(torch, cfg.state_dtype)
    meta = torch.device("meta")

    def mk(p):
        return torch.empty(p.shape, dtype=dt, device=meta)

    return AdamWState(step=torch.empty((), dtype=torch.int32, device=meta),
                      m={k: mk(p) for k, p in abstract_params.items()},
                      v={k: mk(p) for k, p in abstract_params.items()})


def _slices(*ts: torch.Tensor) -> Iterable[Tuple[torch.Tensor, ...]]:
    """Aligned flat slices of same-shape tensors (views: writes land)."""
    flats = [t.view(-1) for t in ts]
    n = flats[0].numel()
    for i in range(0, n, UPDATE_CHUNK):
        yield tuple(f[i:i + UPDATE_CHUNK] for f in flats)


def _sum_sq(leaves) -> Optional[torch.Tensor]:
    parts = [sum(torch.sum(torch.square(c.float()))
                 for (c,) in _slices(x.contiguous()))
             for x in leaves if x.numel()]
    return torch.sum(torch.stack(parts)) if parts else None


@torch.no_grad()
def global_norm(tree: Union[Tensors, Iterable[torch.Tensor]],
                layout: Optional[Tuple] = None) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32.  ``layout``
    = (model group, keys split over it) (``Model.norm_layout``): the split
    leaves' squares are summed over the group, the others counted once."""
    if layout is None:
        leaves = tree.values() if isinstance(tree, Mapping) else tree
        sq = _sum_sq(leaves)
        if sq is None:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(sq)
    import torch.distributed as dist

    group, split = layout
    whole = _sum_sq(v for k, v in tree.items() if k not in split)
    parts = _sum_sq(v for k, v in tree.items() if k in split)
    dev = next(iter(tree.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = (zero if parts is None else parts).reshape(1).clone()
    dist.all_reduce(parts, group=group)
    return torch.sqrt(parts[0] + (zero if whole is None else whole))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0).to(torch.float32)


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled to at most ``max_norm`` in global norm, the norm
    before); each leaf in float32, cast back to its dtype."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


# -- gradient compression (cross-pod all-reduce bandwidth) -------------------

def compress_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16)


def decompress_bf16(g: torch.Tensor, like: torch.dtype) -> torch.Tensor:
    return g.to(like)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 with one float32 scale a tensor; ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    g32 = g.float()
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    like: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(like)


def _round_trip(g: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    if mode in (None, "none"):
        return g
    if mode == "bf16":
        return decompress_bf16(compress_bf16(g), g.dtype)
    if mode == "int8":
        q, s = compress_int8(g)
        return decompress_int8(q, s, g.dtype)
    raise ValueError(f"unknown compression mode {mode!r}")


@torch.no_grad()
def compress_grads(grads: Tensors, mode: Optional[str]) -> Dict[str, torch.Tensor]:
    """Round-trip gradient compression (bf16 / int8 + per-tensor scale),
    leaf by leaf.  As in the JAX package this models the NUMERICS of a
    compressed gradient exchange: the data-parallel all-reduce that
    precedes it (``train_step``) still moves the uncompressed gradients,
    so the wire does not narrow."""
    if mode not in (None, "none", "bf16", "int8"):
        raise ValueError(f"unknown compression mode {mode!r}")
    return {k: _round_trip(g, mode) for k, g in grads.items()}


# -- the update ---------------------------------------------------------------

@torch.no_grad()
def _update_leaf(p, g, m, v, *, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """The JAX package's ``upd`` on one parameter, in place, slice by
    slice; ``g`` is clipped here ((g32 * scale) cast to g's dtype, as
    ``clip_by_global_norm`` does)."""
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    f32 = torch.float32
    for ps, gs, ms, vs in _slices(p, g.contiguous(), m, v):
        g32 = gs.to(f32, copy=True).mul_(scale)
        if gs.dtype != f32:
            g32 = g32.to(gs.dtype).to(f32)
        m32 = ms.to(f32, copy=True).mul_(b1).add_(g32 * (1 - b1))
        v32 = vs.to(f32, copy=True).mul_(b2).add_(g32.square_().mul_(1 - b2))
        del g32
        delta = torch.div(m32, bc1)
        denom = torch.div(v32, bc2).sqrt_().add_(eps)
        delta.div_(denom)
        del denom
        delta.add_(ps.to(f32, copy=True).mul_(wd))
        ps.copy_(ps.to(f32, copy=True).sub_(delta.mul_(lr)))
        ms.copy_(m32)
        vs.copy_(v32)


@torch.no_grad()
def apply_updates(params: Union[torch.nn.Module, Tensors], grads: Tensors,
                  state: AdamWState, cfg: AdamWConfig
                  ) -> Tuple[Union[torch.nn.Module, Tensors], AdamWState, dict]:
    """Clip by global norm, then one AdamW step.  ``params``, ``state.m``
    and ``state.v`` are updated in place (``grads`` are left as they
    were); returns ``(params, AdamWState(step + 1, m, v), {"grad_norm",
    "lr"})`` with the metrics as 0-d float32 tensors."""
    ps = _params(params)
    if set(grads) != set(ps):
        raise KeyError(f"apply_updates: gradients for "
                       f"{sorted(set(grads) ^ set(ps))[:8]} do not match the "
                       "parameters")
    layout = getattr(params, "norm_layout", lambda: None)()
    gnorm = global_norm(grads, layout)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    lr = schedule(cfg, state.step)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for k, p in ps.items():
        _update_leaf(p, grads[k], state.m[k], state.v[k], scale=scale, lr=lr,
                     bc1=bc1, bc2=bc2, cfg=cfg)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                         "lr": lr}
