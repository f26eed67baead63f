"""Device meshes over a ``torch.distributed`` process group.

The caller initialises the group (``init_process_group`` with its store or
address, world size and rank: nothing on the machine tells a program of a
cluster); this module lays the ranks out as a named mesh.  Importing it
touches no device and no group.  Single pod = (data=16, model=16) = 256
ranks; multi-pod = (pod=2, data=16, model=16) = 512, as in the JAX
package's ``launch/mesh.py``.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the initialised group's first 256 (512)
    ranks; raises when the world is smaller."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} — launch {n} "
            "processes (torchrun, one card each) and initialise the "
            "process group before building the production mesh")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """A ``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    with ``mesh_dim_names=("data", "model")`` over the initialised process
    group, whose world size must be ``data * model``.

    ``device_type="cuda"`` first makes card ``rank % device_count`` this
    rank's current device (one card per rank on one host; ranks that share
    a card wrap around); ``"cpu"`` meshes a gloo group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group: call torch.distributed.init_process_group "
                           "first")
    n = data * model
    if dist.get_world_size() != n:
        raise ValueError(f"mesh ({data}, {model}) needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def join_group(data: int, model: int, backend: str, launcher: str) -> bool:
    """Join the ``data * model``-rank group ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or make a one-rank group where the mesh is 1 x 1 and
    no such environment is set; True when the group was made here (the
    caller destroys it).  Exits when the world size is not the mesh's."""
    import os

    import torch.distributed as dist

    n = data * model
    made = False
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        elif n == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            flag = "--data-mesh" if model == 1 else "--model-mesh"
            size = data if model == 1 else model
            raise SystemExit(
                f"{flag} {size} needs {n} ranks: launch with torchrun "
                f"--nproc-per-node {n} -m repro_torch.launch.{launcher} ...")
        made = True
    if dist.get_world_size() != n:
        if made:
            dist.destroy_process_group()
        raise SystemExit(f"a {data} x {model} mesh: the process group has "
                         f"{dist.get_world_size()} ranks")
    return made


def dp_size(mesh) -> int:
    """Data-parallel size: 'data' x 'pod' of a ``DeviceMesh`` or a
    ``(sizes, names)`` pair."""
    from ..parallel.sharding import mesh_shape

    shape = mesh_shape(mesh)
    return int(shape.get("data", 1) * shape.get("pod", 1))
