"""Model API facade: everything launchers and tests need for one
architecture (the JAX package's ``models/registry.py``).

``Model`` is an ``nn.Module`` that holds the parameters of ``model_specs``
(uninitialized until ``init``) on one device, and binds the assembly
functions of ``transformer.py`` to them.  Inputs may be tensors anywhere or
numpy arrays; they are moved to the model's device.

``loss`` runs with autograd (training: ``train/train_step.py``);
``forward``, ``prefill`` and ``decode_step`` run under ``torch.no_grad``.

``mesh``: a ``(data, model)`` ``DeviceMesh`` over an initialised process
group.  The model then holds this rank's shards over 'model', as
``shardings(mesh)`` lays them out (``parallel.sharding.local_shard``; FSDP
over 'data' is not applied), and every entry point runs inside
``sharding_ctx(mesh)``, where the model code meets the other ranks of its
model group.  Every rank of a model group passes the same inputs; a data
rank passes its own slice of the batch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Set, Tuple

import torch

from .._device import DeviceLike, resolve_device
from . import moe, transformer
from .common import (ParamModule, init_params, named_slices, named_specs,
                     param_count)
from .config import ModelConfig


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(ParamModule):
    """One architecture's parameters and entry points.  ``device=None``
    means the card (and raises without one); pass ``device="cpu"`` for the
    host."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 mesh: Any = None):
        dev, dtype = resolve_device(device), _dtype(cfg.dtype)
        if mesh is not None and cfg.is_moe:
            moe.check_mesh(cfg, mesh)
        specs = transformer.model_specs(cfg)
        super().__init__(specs, dtype, dev, mesh)
        self.cfg, self.device, self.dtype = cfg, dev, dtype
        self.param_specs = specs
        self.mesh = mesh

    def _ctx(self):
        from ..parallel import sharding as shd
        return (contextlib.nullcontext() if self.mesh is None
                else shd.sharding_ctx(self.mesh))

    # -- params ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` (on the model's device), with
        the JAX package's distributions; returns ``self``."""
        init_params(self, generator)
        return self

    def n_params(self) -> int:
        return param_count(self.param_specs)

    def abstract(self) -> Dict[str, torch.Tensor]:
        """The JAX package's ``abstract_params``: every parameter as a
        tensor on the ``meta`` device (shape and dtype, no storage), keyed
        by its ``state_dict`` name; over the model's mesh, this rank's
        shard of it (``named_specs`` keeps the full shapes)."""
        meta = ParamModule(self.param_specs, self.dtype, torch.device("meta"),
                           self.mesh)
        return {k: v.detach() for k, v in meta.named_parameters()}

    def shardings(self, mesh=None) -> Dict[str, tuple]:
        """The JAX package's ``param_shardings``: every parameter's DTensor
        placements over ``mesh`` (a ``DeviceMesh`` or ``(sizes, names)``;
        the model's own by default), from its logical axes and shape by
        ``parallel.sharding``.  The model applies their 'model' entries."""
        from ..parallel import sharding as shd
        mesh = self.mesh if mesh is None else mesh
        return shd.Shardings(mesh, {
            k: shd.named_sharding(s.logical, shape=s.shape, mesh=mesh)
            for k, s in named_specs(self)})

    def norm_layout(self) -> Optional[Tuple[Any, Set[str]]]:
        """(the model group, the keys of the parameters split over it) for
        a norm over every parameter that counts each element once; None
        where the model axis is 1."""
        from ..parallel import sharding as shd
        if self.mesh is None or shd.model_size(self.mesh) == 1:
            return None
        return (self.mesh[shd.MODEL].get_group(),
                {k for k, sl in named_slices(self) if sl is not None})

    def _in(self, t, dtype=None):
        if t is None:
            return None
        return torch.as_tensor(t, device=self.device, dtype=dtype)

    # -- compute ----------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens, frames=None) -> torch.Tensor:
        with self._ctx():
            return transformer.forward(self, self._in(tokens, torch.long),
                                       self.cfg, frames=self._in(frames))

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        batch = {k: self._in(v, None if k == "frames" else torch.long)
                 for k, v in batch.items()}
        with self._ctx():
            return transformer.train_loss(self, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int, frames=None):
        with self._ctx():
            return transformer.prefill(self, self._in(tokens, torch.long),
                                       self.cfg, max_len,
                                       frames=self._in(frames))

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        with self._ctx():
            return transformer.decode_step(self, cache,
                                           self._in(token, torch.long),
                                           int(pos), self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        with self._ctx():
            return transformer.init_cache(self.cfg, batch, max_len,
                                          self.dtype, self.device)


def get_model(arch: str, reduced: bool = False,
              device: DeviceLike = None, dtype: Optional[str] = None,
              mesh: Any = None) -> Model:
    """The architecture's ``Model`` with uninitialized weights: call
    ``init(generator)`` (or load a ``state_dict``) before use.  ``dtype``
    overrides the config's; ``mesh`` shards it (see ``Model``)."""
    from ..configs import get_config
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return Model(cfg, device=device, mesh=mesh)
