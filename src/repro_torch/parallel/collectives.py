"""Collectives over the 'model' axis of the active mesh, with Megatron's
conjugate autograd pairs (the port's counterpart of what GSPMD derives
from the JAX package's sharding constraints).

Gradient convention: a tensor replicated over 'model' carries its whole
gradient on every rank; a sharded one carries its shard's.  So:

  * ``copy_to_model``: identity forward, all-reduce backward: a replicated
    tensor (activation or parameter) entering rank-local work, whose
    gradient each rank holds only a part of;
  * ``reduce_from_model``: all-reduce forward, identity backward: partial
    sums leaving rank-local work;
  * ``gather_from_model``: all-gather forward, this rank's slice backward;
  * ``scatter_to_model``: this rank's slice forward, all-gather backward;
  * ``narrow_from_model``: any slice forward (the ranks' slices may
    overlap), the zero-padded gradients all-reduced backward.

Everything is built on ``all_reduce`` and the list form of ``all_gather``,
the two that gloo carries for tensors on the card.  A bfloat16 or
float16 tensor is reduced in float32 and rounded back once, over gloo
and NCCL alike (a gather moves it as it is).  The group is the model subgroup of the active
``sharding_ctx``'s mesh (``mesh["model"]``); outside a context, or over a
model axis of 1, every function is the identity.

``STATS`` counts the collectives and, when ``STATS.enabled``, their host
wall seconds (on the card after a device synchronise, so that the time is
the collective's own and not the kernels queued before it).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from . import sharding as shd


@dataclass
class _Stats:
    enabled: bool = False
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


STATS = _Stats()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor reduced: float32 for a half-width float."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.contiguous()


def _timed(fn, t: torch.Tensor):
    if not STATS.enabled:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    STATS.seconds += time.perf_counter() - t0
    STATS.calls += 1
    STATS.bytes += t.numel() * t.element_size()
    return out


Axis = Optional[shd.ModelAxis]


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               ax: Axis = None) -> torch.Tensor:
    """The reduction of ``t`` over the model axis (``ax``, by default the
    active context's), as a new tensor (no autograd); ``t`` itself where
    the axis is 1."""
    ax = ax or shd.model_axis()
    if ax is None:
        return t
    buf = _wire(t)
    if buf is t:
        buf = t.clone()

    def run():
        dist.all_reduce(buf, op=op, group=ax.group)
        return buf

    return _timed(run, buf).to(t.dtype)


def all_gather(t: torch.Tensor, dim: int, ax: Axis = None) -> torch.Tensor:
    """The model axis's shards of ``t`` concatenated along ``dim`` in rank
    order (no autograd)."""
    ax = ax or shd.model_axis()
    if ax is None:
        return t
    buf = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(buf)
                                 for _ in range(ax.size)]

    def run():
        dist.all_gather(parts, buf, group=ax.group)
        return torch.cat(parts, dim=dim)

    return _timed(run, buf)


def own_slice(t: torch.Tensor, dim: int, ax: Axis = None) -> torch.Tensor:
    """This rank's 1/M of ``t`` along ``dim`` (M the model axis)."""
    ax = ax or shd.model_axis()
    if ax is None:
        return t
    n = t.shape[dim]
    if n % ax.size:
        raise ValueError(f"own_slice: dim {dim} of {tuple(t.shape)} does not "
                         f"split over a model axis of {ax.size}")
    k = n // ax.size
    return t.narrow(dim, ax.rank * k, k)


# Each Function keeps the axis of its forward: backward runs outside the
# sharding context.
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ax=ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax=ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.ax).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return own_slice(x, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


class _Narrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, length, ax):
        ctx.meta, ctx.ax = (x.shape, dim, start, length), ax
        return x.narrow(dim, start, length).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape, dim, start, length = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, start, length).copy_(g)
        return all_reduce(full, ax=ctx.ax), None, None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    ax = shd.model_axis()
    return _Copy.apply(x, ax) if ax and x.requires_grad else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    ax = shd.model_axis()
    return _Reduce.apply(x, ax) if ax else x


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = shd.model_axis()
    return _Gather.apply(x, dim % x.dim(), ax) if ax else x


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = shd.model_axis()
    return _Scatter.apply(x, dim % x.dim(), ax) if ax else x


def narrow_from_model(x: torch.Tensor, dim: int, start: int,
                      length: int) -> torch.Tensor:
    """``x.narrow(dim, start, length)`` of a replicated ``x``, the ranges
    of several ranks free to overlap: the backward sums every rank's
    zero-padded gradient (an all-reduce)."""
    ax = shd.model_axis()
    if ax is None:
        return x.narrow(dim, start, length)
    return _Narrow.apply(x, dim % x.dim(), start, length, ax)


def model_rank_and_size() -> Tuple[int, int]:
    """(this rank's index on the model axis, the axis's size); (0, 1)
    outside a context."""
    ax = shd.model_axis()
    return (0, 1) if ax is None else (ax.rank, ax.size)


def shard_range(n: int) -> Optional[Tuple[int, int]]:
    """[start, stop) of this rank's 1/M of ``n`` entries, or None where the
    axis is 1 or does not divide ``n`` (the tensor stays replicated)."""
    r, m = model_rank_and_size()
    if m == 1 or n % m:
        return None
    k = n // m
    return r * k, (r + 1) * k
