"""Fault-tolerant checkpointing: atomic, async, elastic (the JAX package's
``checkpoint/manager.py``).

Layout per step:  ``<dir>/step_<n>/  arrays_p<rank>.npz  MANIFEST.json``,
written into ``step_<n>.tmp<rank>`` and published with ``os.replace``, so
a crash mid-write never corrupts the latest good checkpoint; the oldest
beyond ``keep_last`` are deleted.  The manifest has the JAX package's
fields: ``step``, ``time``, ``process_index``, ``process_count`` (the rank
and world size of ``torch.distributed``, 0 and 1 without a group),
``keys``, ``shapes``, ``dtypes`` and ``extra``.

Keys are the port's ``state_dict`` names: a model's parameters under their
own names (``decoder.0.attn.wq``), an ``AdamWState`` under ``opt.``
(``opt.step``, ``opt.m.<name>``, ``opt.v.<name>``), a dict's entries under
``<key>.``; a tuple or list concatenates its items' keys.  numpy has no
bfloat16, so a bf16 tensor is stored as its raw 16 bits (``int16``) and the
manifest says ``bfloat16``; ``restore`` puts the bits back, so the round
trip is exact.

The port's data parallelism is replicated: every rank holds the same
arrays, so rank 0 alone writes them (``arrays_p0.npz``), and ``restore``
reads ``arrays_p<rank>.npz`` where it exists and ``arrays_p0.npz`` where
not, on any world size: the JAX package's "elastic restart = same
checkpoint, different mesh".  ``restore`` copies into the tensors of
``tree_like`` in place (casting to their dtype) and returns it.

Over a 'model' axis (tensor parallelism) the checkpoint still holds the
full arrays, as a 1 x 1 run writes them: ``save`` all-gathers each split
leaf over the model group (one leaf at a time, straight to the host) and
``restore`` keeps this rank's shard of each, so a checkpoint saved on any
model axis restores on any other.  ``save`` reads which leaves are split
from the ``Model`` in the tree; ``restore`` from its ``shardings``
(``Model.shardings()``, by default those of a ``Model`` in
``tree_like``).  A leaf takes the sharding of the parameter its key ends
with (``opt.m.<key>`` that of ``<key>``).

``PreemptionGuard`` converts SIGTERM (the cloud preemption signal) into a
"checkpoint now, then exit" request the train loop polls once per step.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import statistics
import threading
import time
from typing import Any, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .._device import process_index_and_count
from ..parallel import sharding as shd
from ..train.optimizer import AdamWState


def _leaves(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, torch.nn.Module):
        for k, v in tree.state_dict(keep_vars=True).items():
            yield prefix + k, v
    elif isinstance(tree, AdamWState):
        yield prefix + "opt.step", tree.step
        for name, moments in (("m", tree.m), ("v", tree.v)):
            for k, v in moments.items():
                yield f"{prefix}opt.{name}.{k}", v
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item, prefix)
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        if not prefix:
            raise ValueError("checkpoint: a bare tensor has no key; wrap it "
                             "in a dict")
        yield prefix[:-1] if prefix.endswith(".") else prefix, tree
    else:
        raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} "
                        f"at {prefix!r}")


def _flatten(tree: Any) -> List[Tuple[str, Any]]:
    flat = list(_leaves(tree, ""))
    keys = [k for k, _ in flat]
    if len(set(keys)) != len(keys):
        dup = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"checkpoint: keys {dup[:8]} occur twice")
    return flat


def _default_shardings(tree: Any):
    """The shardings of the first model over a 'model' axis in ``tree``
    (itself, or an item of a tuple, list or dict); None where none is."""
    items = (tree.values() if isinstance(tree, Mapping) else
             tree if isinstance(tree, (tuple, list)) else (tree,))
    for item in items:
        mesh = getattr(item, "mesh", None)
        if (isinstance(item, torch.nn.Module) and mesh is not None
                and shd.model_size(mesh) > 1):
            return item.shardings()
    return None


def _param_key(shardings, key: str) -> Optional[str]:
    """The parameter key of checkpoint leaf ``key``: its longest dotted
    suffix that ``shardings`` name (``opt.m.<key>`` -> ``<key>``)."""
    if shardings is None:
        return None
    parts = key.split(".")
    for i in range(len(parts)):
        if ".".join(parts[i:]) in shardings:
            return ".".join(parts[i:])
    return None


def _model_dim(shardings, key: str) -> Optional[int]:
    """The dim of checkpoint leaf ``key`` split over 'model'."""
    pk = _param_key(shardings, key)
    return None if pk is None else shardings.model_dim(pk)


def _to_host(v) -> Tuple[np.ndarray, str]:
    """(numpy array, manifest dtype); bf16 as its int16 bits.  A copy, so
    that training may go on updating the tensor while a writer thread
    saves it."""
    if isinstance(v, np.ndarray):
        return v.copy(), str(v.dtype)
    t = v.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        rank, world = process_index_and_count()
        flat = _flatten(tree)
        shardings = _default_shardings(tree)
        ax = None if shardings is None else shd.mesh_model_axis(
            shardings.mesh)
        # Pull to host NOW (one copy); disk IO happens in the background.
        # Every rank joins the gathers of split leaves; rank 0 writes.
        host, dtypes = [], {}
        for k, v in flat:
            dim = _model_dim(shardings, k) if ax is not None else None
            if dim is not None:
                from ..parallel.collectives import all_gather
                v = all_gather(v.detach(), dim, ax)
            if rank == 0:
                arr, dtypes[k] = _to_host(v)
                host.append((k, arr))
            del v
        if rank != 0:
            return
        manifest = {
            "step": step,
            "time": time.time(),
            "process_index": rank,
            "process_count": world,
            "keys": [k for k, _ in host],
            "shapes": {k: list(v.shape) for k, v in host},
            "dtypes": dtypes,
            "extra": extra or {},
        }
        # serialize writers: a blocking save racing an in-flight async save of
        # the same step would have its tmp dir os.replace()d away mid-write
        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest, rank),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, manifest, rank)

    def _write(self, step: int, host, manifest, rank: int) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp{rank}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"arrays_p{rank}.npz"),
                 **{k: v for k, v in host})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp0"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, dict]:
        """Copy the checkpoint of ``step`` (the latest by default) into the
        tensors of ``tree_like``, in place; returns ``(tree_like,
        manifest)``.  ``shardings`` (``Model.shardings()``, by default a
        model's in ``tree_like``): the leaves they split over 'model'
        take this rank's shard of the full array."""
        if shardings is None:
            shardings = _default_shardings(tree_like)
        if shardings is not None and not isinstance(shardings,
                                                    shd.Shardings):
            raise TypeError("restore: shardings are Model.shardings(), a "
                            f"{type(shardings).__name__} names no mesh")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        rank, _ = process_index_and_count()
        own = os.path.join(path, f"arrays_p{rank}.npz")
        data = np.load(own if os.path.exists(own)
                       else os.path.join(path, "arrays_p0.npz"))
        for k, like in _flatten(tree_like):
            if k not in data:
                raise KeyError(f"checkpoint step {step} has no {k!r}")
            src = _from_host(data[k], manifest["dtypes"][k])
            dim = _model_dim(shardings, k)
            if dim is not None:
                src = shd.local_shard(src, shardings[_param_key(shardings, k)],
                                      shardings.mesh)
            if tuple(src.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint {k}: shape {tuple(src.shape)}, "
                                 f"the target {tuple(like.shape)}")
            if isinstance(like, np.ndarray):
                like[...] = src.numpy()
            else:
                like.copy_(src)
        return tree_like, manifest


class PreemptionGuard:
    """SIGTERM -> graceful checkpoint-and-exit for the train loop."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def install(self) -> "PreemptionGuard":
        def handler(signum, frame):
            self.requested = True
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)


class StragglerMonitor:
    """Step-time tracker: flags steps slower than ``threshold`` x the
    running median (detection and counters; re-sharding a slow rank out is
    not done)."""

    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged = 0

    def record(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            slow = dt > self.threshold * med
        self.times.append(dt)
        self.flagged += slow
        return slow
