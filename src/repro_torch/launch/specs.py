"""Fake-tensor stand-ins for every input of one rank's step (the JAX
package's ``launch/specs.py``, whose ``ShapeDtypeStruct``s these replace):
the dry run's inputs (``launch/dryrun.py``).

A stand-in is a ``FakeTensor``: shape, dtype and device (``cuda`` by
default, the card the dry run models), no storage.  Under a mesh it holds
this rank's shape, and its ``global_shape`` attribute records the whole
array's, as the JAX package's leaf carries its global shape and its
sharding.  This rank's shapes follow the port's layout, which departs from
the JAX specs where ROADMAP §3 says so: no parameter or optimizer moment is
split over 'data' (no FSDP); a batch is split over 'data' (and 'pod') as
the port's replicated data parallelism hands each rank its rows, and is
replicated where the data axes do not divide it (``long_500k``'s one
sequence); a KV cache's sequence is split over 'model' only, and an
encoder-decoder's cross-attention cache is replicated.

The parameters are the ``Model``'s own, built under the fake mode (this
rank's shards over 'model', the shapes of ``Model.abstract()``); AdamW's
moments are ``train/optimizer.py``'s ``init_state`` of them.  The args of
each kind match its ``step_fn``: ``(params, opt_state, batch)`` for train,
``(params, tokens[, frames])`` for prefill, ``(params, cache, token, pos)``
for decode, where ``params`` is ``dict(model.named_parameters())`` (the
step runs on the model that holds them).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..models.config import ShapeSpec, shape_by_name
from ..models.common import named_specs
from ..models.registry import Model, get_model
from ..parallel import sharding as shd
from ..train.optimizer import AdamWConfig, init_state
from .mesh import dp_size


def check_device(device) -> None:
    """Fake ``cuda`` tensors need a PyTorch built with CUDA: its Python
    bindings and autograd take a CUDA device guard, which a build without
    CUDA cannot make.  Such a build counts on a fake host (``cpu``), whose
    counts are the same."""
    if torch.device(device).type == "cuda" and not torch.cuda._is_compiled():
        raise RuntimeError(
            "the dry run's fake cuda tensors need a PyTorch built with CUDA; "
            "on this build pass device 'cpu' (--device cpu), which counts "
            "the same step on a fake host")


def _mark(t: torch.Tensor, global_shape) -> torch.Tensor:
    t.global_shape = tuple(int(n) for n in global_shape)
    return t


def local_batch(global_batch: int, mesh) -> int:
    """The rows one rank holds: the batch over the data axes, or all of it
    where they do not divide it (every data rank then runs the same rows)."""
    dp = dp_size(mesh) if mesh is not None else 1
    return global_batch // dp if global_batch % dp == 0 else global_batch


def batch_specs(model: Model, seq_len: int, global_batch: int,
                mesh) -> Dict[str, torch.Tensor]:
    """Under the caller's fake mode: tokens, labels (and frames) of this
    rank's rows, int32 as in the JAX package."""
    cfg, b = model.cfg, local_batch(global_batch, mesh)
    out = {k: _mark(torch.zeros((b, seq_len), dtype=torch.int32,
                                device=model.device), (global_batch, seq_len))
           for k in ("tokens", "labels")}
    if cfg.encdec:
        out["frames"] = _mark(
            torch.zeros((b, seq_len, cfg.frontend_dim), dtype=model.dtype,
                        device=model.device),
            (global_batch, seq_len, cfg.frontend_dim))
    return out


def cache_abstract(model: Model, batch: int, max_len: int,
                   mesh) -> Dict[str, Any]:
    """Under the caller's fake mode: ``model.init_cache`` for this rank's
    rows of a ``batch``-row cache of ``max_len`` positions, each tensor
    marked with its global shape; an encoder-decoder's encoder length is
    ``max_len``."""
    cfg = model.cfg
    cache = model.init_cache(local_batch(batch, mesh), max_len)
    nh, di = cfg.ssm_heads, cfg.d_inner
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    whole = {"k": (batch, max_len, cfg.n_kv_heads, cfg.d_head),
             "v": (batch, max_len, cfg.n_kv_heads, cfg.d_head),
             "ssd": (batch, nh, n, cfg.ssm_headdim),
             "conv_x": (batch, w - 1, di), "conv_B": (batch, w - 1, g, n),
             "conv_C": (batch, w - 1, g, n)}
    for lc in cache["layers"]:
        for key, t in lc.items():
            _mark(t, whole[key])
    if cfg.encdec:
        for key in ("enc_k", "enc_v"):
            for t in cache[key]:
                _mark(t, whole["k"])
        cache["enc_len"] = max_len
    return cache


def input_specs(arch: str, shape: Union[str, ShapeSpec], mesh,
                opt_cfg: Optional[AdamWConfig] = None,
                reduced: bool = False, cfg_override=None, *,
                device: str = "cuda:0", mode=None,
                max_len: Optional[int] = None
                ) -> Tuple[str, Tuple, Dict[str, Any]]:
    """-> (step_kind, args, info).

    step_kind in {'train', 'prefill', 'decode'}; args match the
    corresponding ``step_fn``.  ``shape``: a ``ShapeSpec`` or its name.
    ``mesh``: a ``DeviceMesh`` over an initialised group (the dry run's
    fake one), or None for one rank.  ``cfg_override`` swaps in a modified
    ``ModelConfig``.  ``mode``: the fake mode to build under (a fresh one by
    default; ``info["mode"]``).  ``max_len``: a prefill's cache length
    (its sequence length by default)."""
    shape = shape_by_name(shape) if isinstance(shape, str) else shape
    check_device(device)
    # before the fake mode: the mesh's own bookkeeping is real tensors
    group = data_group(mesh) if shape.kind == "train" else None
    if mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode()
    with mode, (shd.sharding_ctx(mesh) if mesh
                                       is not None else
                                       contextlib.nullcontext()):
        if cfg_override is not None:
            model = Model(cfg_override, device=device, mesh=mesh)
        else:
            model = get_model(arch, reduced=reduced, device=device, mesh=mesh)
        cfg = model.cfg
        whole = dict(named_specs(model))
        params = {k: _mark(p, whole[k].shape)
                  for k, p in model.named_parameters()}
        info: Dict[str, Any] = {"model": model, "mode": mode,
                                "device": device, "shape": shape}
        if shape.kind == "train":
            opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
            opt = init_state(model, opt_cfg)
            for k in params:
                _mark(opt.m[k], whole[k].shape)
                _mark(opt.v[k], whole[k].shape)
            _mark(opt.step, ())
            batch = batch_specs(model, shape.seq_len, shape.global_batch, mesh)
            info.update(opt_cfg=opt_cfg, group=group)
            return "train", (params, opt, batch), info
        if shape.kind == "prefill":
            batch = batch_specs(model, shape.seq_len, shape.global_batch, mesh)
            args = (params, batch["tokens"])
            if cfg.encdec:
                args = args + (batch["frames"],)
            info["max_len"] = max_len or shape.seq_len
            return "prefill", args, info
        # decode: one new token against a seq_len-deep cache
        cache = cache_abstract(model, shape.global_batch, shape.seq_len, mesh)
        token = _mark(torch.zeros((local_batch(shape.global_batch, mesh), 1),
                                  dtype=torch.int32, device=device),
                      (shape.global_batch, 1))
        return "decode", (params, cache, token, shape.seq_len - 1), info


def data_group(mesh):
    """The group a gradient is averaged over: 'data' (x 'pod'); None where
    it is one rank."""
    if mesh is None or dp_size(mesh) == 1:
        return None
    names = mesh.mesh_dim_names
    if "pod" in names:
        return mesh["pod", "data"]._flatten().get_group()
    return mesh["data"].get_group()


def step_fn(kind: str, info: Dict[str, Any]):
    """The function to run for a given cell: its args are ``input_specs``'
    (the parameters among them only to be counted: the model holds them)."""
    model: Model = info["model"]
    if kind == "train":
        from ..train.train_step import make_train_step
        train_step = make_train_step(
            model, info["opt_cfg"],
            n_microbatches=model.cfg.train_microbatches, group=info["group"])

        def train_fn(params, opt_state, batch):
            _, opt_state, metrics = train_step(model, opt_state, batch)
            return opt_state, metrics
        return train_fn
    if kind == "prefill":
        max_len = info["max_len"]

        def prefill_fn(params, tokens, frames=None):
            return model.prefill(tokens, max_len, frames=frames)
        return prefill_fn
    if kind == "decode":
        def decode_fn(params, cache, token, pos):
            return model.decode_step(cache, token, pos)
        return decode_fn
    raise ValueError(kind)

