"""Pipeline parallelism: the GPipe microbatch schedule over the ranks of a
``torch.distributed`` group, one stage a rank (the JAX package's
``parallel/pipeline.py``).

Schedule (forward): T = M + S - 1 ticks for M microbatches over S stages.
At tick t, stage s computes microbatch (t - s) (a bubble otherwise); then
the activations move one hop round the ring of stage ranks (a ``send`` /
``recv`` pair where the JAX package has ``ppermute``); utilization
M / (M + S - 1).  The final stage's outputs at ticks S - 1 .. T - 1 are
microbatches 0 .. M - 1, and a broadcast from it gives every rank the
result (where the JAX package sums a masked output over the stage axis).
Forward only, as there.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_forward(stage_params: Any, x: torch.Tensor,
                     body: Callable[[Any, torch.Tensor], torch.Tensor],
                     group=None) -> torch.Tensor:
    """Run ``body`` S times over ``x`` as an S-stage pipeline, S the size
    of ``group`` (the default group when None), stage s on its rank s.

    ``stage_params``: a tree (dicts, tuples, lists) whose leaves are
    stacked on a leading S dim (``split_stages``); rank s takes slice s.
    ``x``: (M, mb, ...) microbatched inputs, the same on every rank.
    Returns the (M, mb, ...) outputs of the final stage on every rank."""
    import torch.distributed as dist

    n_stages = dist.get_world_size(group)
    sid = dist.get_rank(group)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    my_params = _tree_map(lambda a: a[sid], stage_params)

    def rank_of(stage):
        return stage if group is None else dist.get_global_rank(group, stage)

    prev = rank_of((sid - 1) % n_stages)
    nxt = rank_of((sid + 1) % n_stages)

    ring_in = torch.zeros_like(x[0])
    outs = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (when valid); others take the ring
        inp = x[min(t, n_micro - 1)] if sid == 0 else ring_in
        out = body(my_params, inp)
        outs.append(out)
        if n_stages > 1:
            recv = torch.empty_like(out)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prev, group)])
            for r in reqs:
                r.wait()
            ring_in = recv
    # the final stage emits microbatch (t - S + 1) at tick t
    valid = torch.stack(outs[n_stages - 1:])
    if n_stages > 1:
        dist.broadcast(valid, src=rank_of(n_stages - 1), group=group)
    return valid


def split_stages(params_stacked: Any, n_stages: int) -> Any:
    """(L, ...) layer-stacked params -> (S, L/S, ...) stage-stacked."""
    def r(a):
        n = a.shape[0]
        if n % n_stages != 0:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))
    return _tree_map(r, params_stacked)
