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
to derive them from, so the port's tensors are local shards and
``constrain`` carries out, at the JAX package's call sites, the collective
that gives a tensor the layout its spec names over the 'model' axis
(``parallel/collectives.py``).  The caller says what layout the tensor has
now: replicated (the default), sharded on a dim (``shard=d``) or a partial
sum (``partial=True``).  The port departs from the JAX layouts on purpose
in two places (ROADMAP §3): the residual stream's sequence (``act_seq``,
sequence parallelism) stays replicated over 'model', and a 'data' (or
'pod') axis shards no activation, since under the port's replicated data
parallelism each rank already holds its own slice of the batch.
Parameters are sharded over 'model' only (``local_shard``); FSDP over
'data' is not applied.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

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
_LOCAL_AXES = ("data", "pod")
# the one mesh axis the port shards tensors over
MODEL = "model"
# logical activation axes the port keeps replicated where the JAX package
# shards them over 'model' (sequence parallelism; ROADMAP §3)
PORT_REPLICATED = frozenset({"act_seq"})


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


def bound(fn):
    """``fn`` made to run inside the context active now (or none): for
    work that runs later, as a checkpointed layer's recompute runs in
    backward, outside the context of its forward."""
    saved = (_CTX.mesh, _CTX.rules) if active() else None

    def run(*args, **kwargs):
        if saved is None:
            return fn(*args, **kwargs)
        with sharding_ctx(saved[0], saved[1]):
            return fn(*args, **kwargs)

    return run


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


class ModelAxis(NamedTuple):
    group: Any          # the model subgroup (a torch.distributed group)
    rank: int           # this rank's index along 'model'
    size: int


def _coordinate(mesh: Any, axis: str) -> int:
    """This rank's index along ``axis`` of a ``DeviceMesh``."""
    if not hasattr(mesh, "get_local_rank"):
        raise ValueError(f"a {mesh_shape(mesh).get(axis)}-way {axis!r} axis "
                         "needs a DeviceMesh over an initialised process "
                         "group (a shape alone names no rank)")
    return int(mesh.get_local_rank(axis))


class MeshView:
    """Rank ``model_rank`` of a (data, model) mesh of ``shape`` as it sees
    the mesh, without a process group: what ``Model``, ``restore`` and
    ``constrain`` read of a ``DeviceMesh`` to take a replicated array's
    slice, which moves no data between ranks (its group is never used)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, model_rank: int, shape: Tuple[int, int]):
        self.rank, self.shape = model_rank, shape

    def get_local_rank(self, name: str) -> int:
        return self.rank if name == MODEL else 0

    def __getitem__(self, name: str) -> "MeshView":
        return self

    def get_group(self):
        return None


def mesh_model_axis(mesh: Any) -> Optional[ModelAxis]:
    """The 'model' axis of ``mesh`` as this rank sees it; None where it
    is 1."""
    size = mesh_shape(mesh).get(MODEL, 1)
    if size == 1:
        return None
    return ModelAxis(mesh[MODEL].get_group(), _coordinate(mesh, MODEL), size)


def model_axis() -> Optional[ModelAxis]:
    """The active context's 'model' axis, or None outside a context and
    where the axis is 1."""
    return mesh_model_axis(_CTX.mesh) if active() else None


class Shardings(dict):
    """Parameter key -> DTensor placements (``Model.shardings``), with the
    mesh they lay the parameters out on."""

    def __init__(self, mesh: Any, placements: Dict[str, Tuple]):
        super().__init__(placements)
        self.mesh = mesh

    def model_dim(self, key: str) -> Optional[int]:
        """The dim of ``key`` split over 'model' (None where whole)."""
        from torch.distributed.tensor import Shard

        names = list(mesh_shape(self.mesh))
        if MODEL not in names or mesh_shape(self.mesh)[MODEL] == 1:
            return None
        pl = self[key][names.index(MODEL)]
        return pl.dim if isinstance(pl, Shard) else None


def model_size(mesh: Any = None) -> int:
    mesh = mesh if mesh is not None else (_CTX.mesh if active() else None)
    return 1 if mesh is None else mesh_shape(mesh).get(MODEL, 1)


def _model_dim(spec: Tuple) -> Optional[int]:
    for i, entry in enumerate(spec):
        if MODEL in ((entry,) if isinstance(entry, str) else entry or ()):
            return i
    return None


def local_slice(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                mesh: Any) -> Optional[Tuple[int, int, int]]:
    """(dim, start, length) of this rank's shard over 'model' of a tensor
    of logical axes ``logical_axes`` and full ``shape``; None where it is
    replicated over 'model'."""
    m = model_size(mesh)
    if m == 1:
        return None
    dim = _model_dim(pspec(logical_axes, shape=shape, mesh=mesh))
    if dim is None:
        return None
    k = shape[dim] // m
    return dim, _coordinate(mesh, MODEL) * k, k


def local_shard(tensor, placements: Sequence, mesh: Any):
    """This rank's piece of the full ``tensor`` under DTensor
    ``placements`` (one per mesh dim, as ``named_sharding`` gives them),
    over the 'model' axis only: the port applies no FSDP over 'data'."""
    from torch.distributed.tensor import Shard

    names = list(mesh_shape(mesh))
    if len(placements) != len(names):
        raise ValueError(f"local_shard: {len(placements)} placements for a "
                         f"mesh of {names}")
    for name, pl in zip(names, placements):
        if name != MODEL or not isinstance(pl, Shard):
            continue
        m = mesh_shape(mesh)[name]
        n = tensor.shape[pl.dim]
        if n % m:
            raise ValueError(f"local_shard: dim {pl.dim} of "
                             f"{tuple(tensor.shape)} does not split {m} ways")
        k = n // m
        tensor = tensor.narrow(pl.dim, _coordinate(mesh, name) * k, k)
    return tensor


def constrain(x, *logical_axes: Optional[str], shard: Optional[int] = None,
              partial: bool = False):
    """Give ``x`` the layout over 'model' that the JAX spec of
    ``logical_axes`` names (``act_seq`` read as replicated, 'data' and
    'pod' as local), by the collective that gets it there: an all-reduce
    from a partial sum (then this rank's slice where the target is
    sharded: a reduce-scatter), an all-gather from a shard on another dim,
    this rank's slice from a replicated tensor.  ``shard=d`` says ``x`` is
    this rank's shard of dim ``d``, ``partial`` that it is a partial sum;
    by default it is replicated.  The identity outside a context and over a
    model axis of 1.  Every collective has its conjugate backward
    (``parallel/collectives.py``)."""
    if not active():
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {len(logical_axes)} logical axes for "
                         f"a tensor of shape {tuple(x.shape)}")
    if shard is not None and partial:
        raise ValueError("constrain: a tensor is sharded or partial, not both")
    m = model_size()
    if m == 1:
        return x
    from . import collectives as coll

    full = list(x.shape)
    if shard is not None:
        shard %= x.dim()
        full[shard] *= m
    logical = tuple(None if a in PORT_REPLICATED else a
                    for a in logical_axes)
    # over the model axis alone: 'data' and 'pod' shard no activation here
    want = _model_dim(pspec(logical, shape=full, mesh={MODEL: m}))
    if partial:         # a reduce-scatter where the target is sharded
        x = coll.reduce_from_model(x)
        return x if want is None else coll.scatter_to_model(x, want)
    if shard is None:
        return x if want is None else coll.scatter_to_model(x, want)
    if want == shard:
        return x
    x = coll.gather_from_model(x, shard)
    return x if want is None else coll.scatter_to_model(x, want)
