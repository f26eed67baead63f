"""The training step: loss -> grads -> (data-parallel mean) -> (optional
compression) -> AdamW (the JAX package's ``train/train_step.py``).

Gradients come from autograd (``Model.loss`` then ``backward``).  With
``n_microbatches`` above 1 the batch splits into that many leading chunks,
as the JAX package's ``lax.scan`` splits it, and the gradients accumulate
in float32 buffers: what reaches the all-reduce, the compression and the
clip is then float32.  With one microbatch the gradients stay in the
parameters' dtype (bf16 for a bf16 model), as ``jax.value_and_grad``
returns them.

Data parallelism is replicated: every rank holds the whole model and its
own slice of the batch (``TokenPipeline.host_slice``).  With a
``group``, one all-reduce sums the gradients and the loss (one float32
buffer), and each is divided by the group's size: the mean over the
global batch, before compression and the clip, which is where XLA's
reduction sits in the JAX package.  Every rank then applies the same
update.  Gloo may not reduce bf16 tensors on the card, so the buffer is
float32 for every gradient dtype; a bf16 gradient's mean is rounded back
to bf16 once.  A model past ``REDUCE_BUCKET`` gradient elements reduces in
buckets of that size, so the float32 copy never holds every gradient.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .optimizer import AdamWConfig, AdamWState, apply_updates, compress_grads


# float32 elements an all-reduce bucket holds (256 MiB)
REDUCE_BUCKET = 1 << 26


def _buckets(sizes, cap: int):
    """Consecutive runs of leaves of at most ``cap`` elements (a larger
    leaf alone)."""
    run, total = [], 0
    for i, n in enumerate(sizes):
        if run and total + n > cap:
            yield run
            run, total = [], 0
        run.append(i)
        total += n
    if run:
        yield run


def _all_reduce_mean(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                     group) -> torch.Tensor:
    """Mean of ``loss`` and of every gradient over ``group``, reduced in
    float32 buckets of up to ``REDUCE_BUCKET`` elements (one all-reduce in
    all for the reduced archs; the loss rides in the first); the
    gradients are written back in place."""
    import torch.distributed as dist

    keys = list(grads)
    world = dist.get_world_size(group)
    sizes = [1] + [grads[k].numel() for k in keys]
    lead = loss.detach().reshape(1).float()
    out = loss
    for run in _buckets(sizes, REDUCE_BUCKET):
        flat = torch.cat([lead if i == 0 else
                          grads[keys[i - 1]].reshape(-1).float() for i in run])
        dist.all_reduce(flat, group=group)
        flat /= world
        at = 0
        for i in run:
            if i == 0:
                out = flat[0].clone()
            else:
                g = grads[keys[i - 1]]
                g.copy_(flat[at:at + g.numel()].view(g.shape))
            at += sizes[i]
    return out


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``; zeros (set as ``p.grad``) where no loss term reached
    ``p``, as ``jax.grad`` gives."""
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    return p.grad


def make_train_step(model, opt_cfg: AdamWConfig, n_microbatches: int = 1,
                    compression: Optional[str] = None, group=None,
                    mark: Optional[Callable[[str], None]] = None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; the parameters and the moments update in place.

    ``batch["tokens"]`` / ``["labels"]`` (and ``["frames"]``) are (B, S...)
    tensors or numpy arrays; with microbatching B splits into
    ``n_microbatches`` leading chunks.  ``metrics`` are 0-d float32 tensors
    on the model's device: ``loss`` (before compression), ``grad_norm``
    (after the all-reduce and the compression, before the clip) and
    ``lr``.  After a single-microbatch step each parameter's ``.grad``
    holds the gradient the clip saw; the next step frees it first.
    ``group``: a ``torch.distributed`` group to average over (data
    parallelism).  ``mark(name)``, when given, is called with ``"grads"``
    once the gradients are final and with ``"update"`` after AdamW (a
    hook for timers; it must not touch the tensors)."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
    compress_grads({}, compression)          # reject an unknown mode now

    def single(model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss = model.loss(batch)
        loss.backward()
        return loss.detach(), {k: _grad(p) for k, p in
                               model.named_parameters()}

    def accumulated(model, batch):
        b = batch["tokens"].shape[0]
        if b % n_microbatches != 0:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches")
        mb = b // n_microbatches
        named = dict(model.named_parameters())
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in named.items()}
        acc_loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n_microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = model.loss(part)
            loss.backward()
            with torch.no_grad():
                acc_loss += loss.detach()
                for k, p in named.items():
                    if p.grad is not None:
                        acc[k] += p.grad.float()
                    p.grad = None
        inv = 1.0 / n_microbatches
        with torch.no_grad():
            for g in acc.values():
                g.mul_(inv)
        return acc_loss * inv, acc

    def train_step(model, opt_state: AdamWState, batch: Dict[str, Any]):
        for p in model.parameters():
            p.grad = None
        if n_microbatches > 1:
            loss, grads = accumulated(model, batch)
        else:
            loss, grads = single(model, batch)
        with torch.no_grad():
            if group is not None:
                loss = _all_reduce_mean(loss, grads, group)
            if compression not in (None, "none"):
                grads = compress_grads(grads, compression)
                if n_microbatches == 1:
                    for k, p in model.named_parameters():
                        p.grad = grads[k]
        if mark is not None:
            mark("grads")
        model, opt_state, metrics = apply_updates(model, grads, opt_state,
                                                  opt_cfg)
        if mark is not None:
            mark("update")
        return model, opt_state, {**metrics, "loss": loss.float()}

    return train_step
