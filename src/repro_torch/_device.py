"""Device and process resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises:
    the host runs only when the caller passes ``device="cpu"``.  Under a
    ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) a ``cuda``
    device is fake and needs no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and \
            torch._guards.detect_fake_mode() is None:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev


def process_index_and_count():
    """(rank, world size) of the initialised ``torch.distributed`` group;
    (0, 1) without one (the JAX package's ``jax.process_index()`` and
    ``jax.process_count()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
