"""Carry state from the JAX package into the port: an encoded database
(``dense_db_from_reference``), a model's parameters
(``model_from_reference``), its AdamW state (``opt_state_from_reference``)
and a training checkpoint the JAX package wrote
(``checkpoint_from_reference``).

The JAX package's ``DenseDB`` state is its vocabulary items, its (U, W)
uint32 bitmap and its (U, C) int32 weights.  Handed over as plain Python and
numpy values (``vocab.items``, ``np.asarray(db.bits)``,
``np.asarray(db.weights)``), it becomes the port's ``DenseDB`` on ``device``
byte for byte, so both packages can count the same encoded rows.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Hashable, Mapping, Optional, Sequence, Tuple

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
                         device: DeviceLike = None, mesh: Any = None):
    """The JAX package's parameter tree for ``cfg`` (every leaf a numpy
    array: ``jax.tree.map(np.asarray, params)``) as the port's ``Model`` on
    ``device``, in ``cfg.dtype``.  The same inputs then give the same logits.
    Over ``mesh`` (a ``DeviceMesh``) the model keeps this rank's shards of
    each array (``Model.shardings``; see ``Model``).

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
    from .models.registry import Model

    model = Model(cfg, device=device, mesh=mesh)
    state = _check_keys("model_from_reference", reference_state(cfg, params),
                        model)
    with torch.no_grad():
        for key, t in model.named_parameters():
            t.copy_(state[key])
    return model


def _local(model, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full arrays keyed like the model's parameters -> this rank's
    shards (the arrays themselves without a mesh)."""
    if model.mesh is None:
        return state
    from .parallel.sharding import local_shard
    pl = model.shardings()
    return {k: local_shard(v, pl[k], model.mesh) if k in pl else v
            for k, v in state.items()}


def reference_state(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX package's parameters (its parameters, or
    AdamW's ``m`` or ``v``) as CPU tensors under the port's ``state_dict``
    keys, by the key map of ``model_from_reference``."""
    from .models.blocks import unit_layout
    from .models.transformer import _enc_cfg

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
    for path, leaf in flat(tree, ()):
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
    return state


def _check_keys(who: str, state: Dict[str, torch.Tensor], model):
    state = _local(model, state)
    want = dict(model.named_parameters())
    if set(state) != set(want):
        raise KeyError(f"{who}: keys differ: missing "
                       f"{sorted(set(want) - set(state))[:8]}, unexpected "
                       f"{sorted(set(state) - set(want))[:8]}")
    for key, arr in state.items():
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"{who}: {key} has shape {tuple(arr.shape)}, "
                             f"the model {tuple(want[key].shape)}")
    return state


def opt_state_from_reference(cfg, opt_state: Any, model):
    """The JAX package's ``AdamWState`` (``step``, and ``m`` and ``v``
    stacked like the parameters; numpy leaves) as the port's, on the
    model's device: the moments keep their dtype (the config's
    ``state_dtype``), take the parameters' keys by the key map of
    ``model_from_reference`` and, over the model's mesh, its shards."""
    from .train.optimizer import AdamWState

    step, m, v = (opt_state.step, opt_state.m, opt_state.v) \
        if hasattr(opt_state, "step") else opt_state
    dev = model.device
    moments = [{k: t.to(dev) for k, t in _check_keys(
        f"opt_state_from_reference ({name})", reference_state(cfg, tree),
        model).items()} for name, tree in (("m", m), ("v", v))]
    return AdamWState(
        step=torch.as_tensor(int(np.asarray(step)), dtype=torch.int32,
                             device=dev),
        m=moments[0], v=moments[1])


_KEYSTR = re.compile(r"\[(\d+)\]|\['([^']*)'\]|\.(\w+)")


def _keystr_path(key: str) -> Tuple:
    """``jax.tree_util.keystr`` of a path -> its entries (ints and names)."""
    out, at = [], 0
    for m in _KEYSTR.finditer(key):
        if m.start() != at:
            raise ValueError(f"cannot parse checkpoint key {key!r}")
        at = m.end()
        idx, name, attr = m.groups()
        out.append(int(idx) if idx is not None else (name or attr))
    if at != len(key):
        raise ValueError(f"cannot parse checkpoint key {key!r}")
    return tuple(out)


def checkpoint_from_reference(directory: str, model, step: Optional[int] = None):
    """Read a checkpoint that the JAX package's ``CheckpointManager`` wrote
    of ``(params, opt_state)`` (its launcher's tree; keys are
    ``jax.tree_util.keystr`` paths, bf16 stored as 2-byte voids) into the
    port: the parameters are copied into ``model`` in place; returns
    ``(AdamWState, manifest)``, so that a JAX training run resumes in the
    port at ``manifest["step"]``."""
    import json
    import os

    from .checkpoint.manager import CheckpointManager, _from_host

    if step is None:
        step = CheckpointManager(directory).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays_p0.npz"))
    trees: Dict[Any, Any] = {}
    opt_step = None
    for key in manifest["keys"]:
        leaf = _from_host(data[key], manifest["dtypes"][key])
        path_ = _keystr_path(key)
        if path_ == (1, "step"):
            opt_step = leaf
            continue
        root = {0: ("params",), 1: ("opt",)}.get(path_[0])
        if root is None or (path_[0] == 1 and path_[1] not in ("m", "v")):
            raise KeyError(f"checkpoint_from_reference: unexpected key {key!r}"
                           " (expected the launcher's (params, opt_state))")
        node = trees
        for part in root + path_[1:-1]:
            node = node.setdefault(part, {})
        node[path_[-1]] = leaf
    cfg = model.cfg
    state = _check_keys("checkpoint_from_reference",
                        reference_state(cfg, trees["params"]), model)
    with torch.no_grad():
        for key, t in model.named_parameters():
            t.copy_(state[key])
    opt = opt_state_from_reference(
        cfg, (opt_step, trees["opt"]["m"], trees["opt"]["v"]), model)
    return opt, manifest


def _numpy(leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; bfloat16 (``ml_dtypes``) by its bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))
