"""Carry state from the JAX package into the port: an encoded database
(``dense_db_from_reference``) and a model's parameters
(``model_from_reference``).

The JAX package's ``DenseDB`` state is its vocabulary items, its (U, W)
uint32 bitmap and its (U, C) int32 weights.  Handed over as plain Python and
numpy values (``vocab.items``, ``np.asarray(db.bits)``,
``np.asarray(db.weights)``), it becomes the port's ``DenseDB`` on ``device``
byte for byte, so both packages can count the same encoded rows.
"""
from __future__ import annotations

from typing import Any, Dict, Hashable, Mapping, Sequence

import numpy as np
import torch

from ._device import DeviceLike
from .mining.dense import DenseDB
from .mining.encode import ItemVocab


def dense_db_from_reference(vocab_items: Sequence[Hashable], bits: np.ndarray,
                            weights: np.ndarray, n_rows: int, n_classes: int,
                            *, device: DeviceLike = None) -> DenseDB:
    bits = np.asarray(bits)
    weights = np.asarray(weights)
    if bits.dtype != np.uint32 or weights.dtype != np.int32:
        raise TypeError(f"dense_db_from_reference: expected uint32 bits and "
                        f"int32 weights, got {bits.dtype} / {weights.dtype}")
    if bits.shape[0] != weights.shape[0] or weights.shape[1] != n_classes:
        raise ValueError(f"dense_db_from_reference: bits {bits.shape} and "
                         f"weights {weights.shape} do not match "
                         f"n_classes={n_classes}")
    return DenseDB.from_arrays(ItemVocab(tuple(vocab_items)), bits, weights,
                               n_rows, n_classes, device=device)


def model_from_reference(cfg, params: Mapping[str, Any], *,
                         device: DeviceLike = None):
    """The JAX package's parameter tree for ``cfg`` (every leaf a numpy
    array: ``jax.tree.map(np.asarray, params)``) as the port's ``Model`` on
    ``device``, in ``cfg.dtype``.  The same inputs then give the same logits.

    Key map (JAX tree path -> port ``state_dict`` key).  Leaves outside the
    layer stacks keep their names: ``tok_embed``, ``lm_head``,
    ``final_norm``, ``enc_in_proj``, ``enc_norm``.  The JAX package stacks
    each scan unit's leaves along a leading axis; with ``n, unit =
    unit_layout(cfg)`` and ``U = len(unit)``:

    - one-layer units (U = 1): ``decoder/<path>[u]`` -> ``decoder.<u>.<path>``
    - superblocks (jamba, U = 8; MoE every 2nd layer, U = 2):
      ``decoder/layer<i>/<path>[u]`` -> ``decoder.<u * U + i>.<path>``
    - the encoder (always U = 1): ``encoder/<path>[u]`` -> ``encoder.<u>.<path>``

    where ``<path>`` is the leaf's dict path joined by ``.``, e.g.
    ``decoder/attn/wq[3]`` -> ``decoder.3.attn.wq`` and
    ``decoder/layer3/moe/router[0]`` -> ``decoder.3.moe.router``.  Every
    leaf keeps its JAX shape and axis order."""
    from .models.blocks import unit_layout
    from .models.registry import Model
    from .models.transformer import _enc_cfg

    model = Model(cfg, device=device)
    state: Dict[str, torch.Tensor] = {}

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    stacks = {"decoder": len(unit_layout(cfg)[1])}
    if cfg.encdec:
        stacks["encoder"] = len(unit_layout(_enc_cfg(cfg))[1])
    for path, leaf in flat(params, ()):
        leaf = _numpy(leaf)
        if path[0] not in stacks:
            state[".".join(path)] = leaf
            continue
        unit = stacks[path[0]]
        rest = path[1:]
        first = 0
        if unit > 1:
            first, rest = int(rest[0][len("layer"):]), rest[1:]
        for u in range(leaf.shape[0]):
            state[".".join((path[0], str(u * unit + first)) + rest)] = leaf[u]
    want = dict(model.named_parameters())
    if set(state) != set(want):
        raise KeyError(f"model_from_reference: keys differ: missing "
                       f"{sorted(set(want) - set(state))[:8]}, unexpected "
                       f"{sorted(set(state) - set(want))[:8]}")
    with torch.no_grad():
        for key, arr in state.items():
            t = want[key]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"model_from_reference: {key} has shape "
                                 f"{arr.shape}, the model {tuple(t.shape)}")
            t.copy_(arr)
    return model


def _numpy(leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; bfloat16 (``ml_dtypes``) by its bits."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))
