"""Device meshes over a ``torch.distributed`` process group.

The caller initialises the group (``init_process_group`` with its store or
address, world size and rank: nothing on the machine tells a program of a
cluster); this module lays the ranks out as a named mesh.  Importing it
touches no device and no group.
"""
from __future__ import annotations


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
