"""Model API facade: everything launchers and tests need for one
architecture (the JAX package's ``models/registry.py``).

``Model`` is an ``nn.Module`` that holds the parameters of ``model_specs``
(uninitialized until ``init``) on one device, and binds the assembly
functions of ``transformer.py`` to them.  Inputs may be tensors anywhere or
numpy arrays; they are moved to the model's device.

``loss`` runs with autograd (training: ``train/train_step.py``);
``forward``, ``prefill`` and ``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device
from . import transformer
from .common import ParamModule, init_params, named_specs, param_count
from .config import ModelConfig


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(ParamModule):
    """One architecture's parameters and entry points.  ``device=None``
    means the card (and raises without one); pass ``device="cpu"`` for the
    host."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        dev, dtype = resolve_device(device), _dtype(cfg.dtype)
        specs = transformer.model_specs(cfg)
        super().__init__(specs, dtype, dev)
        self.cfg, self.device, self.dtype = cfg, dev, dtype
        self.param_specs = specs

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
        by its ``state_dict`` name."""
        meta = ParamModule(self.param_specs, self.dtype, torch.device("meta"))
        return {k: v.detach() for k, v in meta.named_parameters()}

    def shardings(self, mesh) -> Dict[str, tuple]:
        """The JAX package's ``param_shardings``: every parameter's DTensor
        placements over ``mesh`` (a ``DeviceMesh`` or ``(sizes, names)``),
        from its logical axes and shape by ``parallel.sharding``.  Computed
        here; applied with the mesh slice (ROADMAP queue 1 item 4 (ii))."""
        from ..parallel import sharding as shd
        return {k: shd.named_sharding(s.logical, shape=s.shape, mesh=mesh)
                for k, s in named_specs(self)}

    def _in(self, t, dtype=None):
        if t is None:
            return None
        return torch.as_tensor(t, device=self.device, dtype=dtype)

    # -- compute ----------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens, frames=None) -> torch.Tensor:
        return transformer.forward(self, self._in(tokens, torch.long),
                                   self.cfg, frames=self._in(frames))

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        batch = {k: self._in(v, None if k == "frames" else torch.long)
                 for k, v in batch.items()}
        return transformer.train_loss(self, batch, self.cfg)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int, frames=None):
        return transformer.prefill(self, self._in(tokens, torch.long),
                                   self.cfg, max_len,
                                   frames=self._in(frames))

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        return transformer.decode_step(self, cache,
                                       self._in(token, torch.long),
                                       int(pos), self.cfg)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return transformer.init_cache(self.cfg, batch, max_len, self.dtype,
                                      self.device)


def get_model(arch: str, reduced: bool = False,
              device: DeviceLike = None, dtype: Optional[str] = None) -> Model:
    """The architecture's ``Model`` with uninitialized weights: call
    ``init(generator)`` (or load a ``state_dict``) before use.  ``dtype``
    overrides the config's."""
    from ..configs import get_config
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return Model(cfg, device=device)
