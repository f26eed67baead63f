"""Logical-axis sharding: one rules table maps logical tensor axes to mesh
axes (the JAX package's ``parallel/sharding.py``).

The rules, the context and ``pspec`` are copies: the same divisibility
drop (a dim that does not divide its mesh axes stays unsharded) and the
same no-reuse of a mesh axis within one spec.  A mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
with named dims, a ``(sizes, names)`` pair or a ``{name: size}`` dict.
``pspec`` returns a tuple whose entries equal those of the JAX
``PartitionSpec`` for the same mesh shape; ``named_sharding`` turns it
into DTensor placements, one per mesh dim.

``constrain`` is where the two packages part.  XLA's GSPMD derives the
collectives of a sharded program from constraints; eager PyTorch has none
to derive them from.  So ``constrain`` is the identity outside a context,
and over a mesh whose non-data axes are all 1.  Under the port's
replicated data parallelism each rank already holds its own slice of the
batch, so a 'data' axis above 1 leaves activations as they are.  A
'model' (or 'pod') axis above 1 raises ``NotImplementedError``: tensor
parallelism is ROADMAP queue 1 item 4 (ii).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]

# Logical axis -> preferred mesh axes.
DEFAULT_RULES: Dict[Optional[str], Axes] = {
    # --- weights ---
    "embed": "data",            # FSDP dim of weight matrices
    "ffn": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "experts": "model",
    "vocab_in": None,           # embedding table rows (gather stays local)
    "embed_tbl": "model",       # embedding table cols
    "vocab_out": "model",       # lm-head output dim
    "layers": None,             # scan-stacked dim
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_chan": "model",
    "norm": None,
    # --- activations ---
    "act_batch": ("pod", "data"),
    "act_seq": "model",         # sequence-parallel residual stream
    "act_kv_seq": "model",      # split-KV decode
    "act_kv_seq_long": ("data", "model"),  # 524k single-sequence decode
    "act_heads": "model",
    "act_ffn": "model",
    "act_vocab": "model",
    "act_embed": None,
    "act_experts": "model",
    "act_groups": ("pod", "data"),
    "act_ssm_heads": "model",
    None: None,
}

# mesh axes along which the port's eager code holds no sharded activation
_LOCAL_AXES = ("data",)


class _Ctx(threading.local):
    mesh: Any = None
    rules: Dict[Optional[str], Axes] = DEFAULT_RULES
    enabled: bool = False


_CTX = _Ctx()


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a ``(sizes, names)`` pair
    or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    sizes, names = mesh
    if len(sizes) != len(names):
        raise ValueError(f"mesh sizes {sizes} and names {names} differ in "
                         "length")
    return dict(zip(names, (int(s) for s in sizes)))


@contextlib.contextmanager
def sharding_ctx(mesh: Any, rules: Optional[Dict[Optional[str], Axes]] = None):
    """Enable logical-axis constraints inside model code."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.enabled)
    _CTX.mesh, _CTX.rules, _CTX.enabled = (mesh, {**DEFAULT_RULES,
                                                  **(rules or {})}, True)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.enabled = prev


def active() -> bool:
    return _CTX.enabled and _CTX.mesh is not None


def active_mesh_shape() -> Dict[str, int]:
    """The active context's mesh shape (empty outside a context)."""
    return mesh_shape(_CTX.mesh) if active() else {}


def _mesh_axes_for(logical: Optional[str], shape: Dict[str, int],
                   rules: Dict[Optional[str], Axes]) -> Tuple[str, ...]:
    ax = rules.get(logical, None)
    if ax is None:
        return ()
    if isinstance(ax, str):
        ax = (ax,)
    return tuple(a for a in ax if a in shape)


def pspec(logical_axes: Sequence[Optional[str]],
          shape: Optional[Sequence[int]] = None, mesh: Any = None,
          rules: Optional[Dict[Optional[str], Axes]] = None) -> Tuple:
    """Logical axes -> a spec tuple (``None``, an axis name, or a tuple of
    names per dim, trailing ``None``s dropped), dropping non-divisible
    constraints."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        raise ValueError("pspec: no mesh given and no sharding_ctx active")
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        axes = _mesh_axes_for(name, sizes, rules)
        axes = tuple(a for a in axes if a not in used)
        if shape is not None and axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if shape[i] % total != 0:
                axes = ()  # padding-free: leave unsharded, report as waste
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: Tuple, mesh: Any) -> Tuple:
    """A spec tuple as DTensor placements, one per mesh dim in the mesh's
    order: ``Shard(i)`` where dim ``i`` of the tensor names the mesh axis,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            where[axis] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh_shape(mesh))


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   mesh: Any = None) -> Tuple:
    """The DTensor placements of ``pspec(logical_axes, shape, mesh)``."""
    mesh = mesh if mesh is not None else _CTX.mesh
    return placements(pspec(logical_axes, shape=shape, mesh=mesh), mesh)


def constrain(x, *logical_axes: Optional[str]):
    """The identity outside a context and over a mesh whose non-data axes
    are all 1; raises ``NotImplementedError`` where the JAX package would
    shard an activation over a larger 'model' or 'pod' axis (see the
    module docstring)."""
    if not active():
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for "
                         f"a tensor of shape {tuple(x.shape)}")
    sizes = mesh_shape(_CTX.mesh)
    if all(n == 1 for a, n in sizes.items() if a not in _LOCAL_AXES):
        return x
    spec = pspec(logical_axes, shape=tuple(x.shape))
    named = {a for e in spec for a in ((e,) if isinstance(e, str)
                                       else e or ())}
    if all(sizes[a] == 1 or a in _LOCAL_AXES for a in named):
        return x
    raise NotImplementedError(
        f"constrain{tuple(logical_axes)} over mesh {sizes}: sharding an "
        "activation over a 'model' axis above 1 needs the port's tensor "
        "parallelism (ROADMAP queue 1 item 4 (ii)); eager PyTorch has no "
        "GSPMD to derive the collectives from")
