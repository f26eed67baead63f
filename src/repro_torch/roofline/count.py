"""Counting one rank's eager step at the dispatcher: what the dry run
(``launch/dryrun.py``) reads where the JAX package reads XLA's
``memory_analysis`` and ``cost_analysis``.

``StepCounter`` is a ``TorchDispatchMode`` that sees every aten and c10d op
the step dispatches, on fake tensors (the dry run) or on real ones (the
card and CPU runs it is held against):

* **bytes accessed**: the bytes of every distinct tensor each op reads or
  writes (inputs plus outputs, a tensor once an op), views and collectives
  left out.  Eager PyTorch runs every op unfused, so this is the eager
  traffic, not a fused program's;
* **collectives**: each ``c10d`` op (``allreduce_``, ``allgather_``,
  ``broadcast_``, ...) with its kind, its group's size and its result
  bytes, and the wire bytes of the ring model (``analysis.CollectiveStats``).
  These are the ops as they reach the dispatcher, whoever called them:
  ``parallel/collectives.py`` (bf16 reduced as float32, as sent) and the
  all-reduces that bypass it (the data-parallel gradient mean, the clip's
  norm, the pipeline's broadcast);
* **memory**: the bytes of the live storages.  ``hold(tree)`` registers
  the step's arguments; every storage an op returns that is not yet live is
  an allocation, freed when Python drops its last reference (a weak
  reference's callback), as eager frees it.  ``peak_bytes`` is the most live
  at once, the arguments included.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matmul-class
ops only), entered beside this mode by ``count_step``.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .analysis import CollectiveStats

# c10d op name -> the ring model's kind
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast_": "broadcast",
}
# c10d ops that move nothing of their own (the receiving half of a send,
# barriers, monitored waits)
C10D_SILENT = {"recv_", "recv_any_source_", "barrier", "monitored_barrier_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    from torch.distributed import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(ProcessGroup.unbox(a).size())
        if isinstance(a, ProcessGroup):
            return int(a.size())
    raise ValueError("a c10d op without a process group argument")


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in ``tree``: pytrees, and dataclass instances such as
    ``AdamWState`` field by field."""
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out.extend(_tensors([getattr(leaf, f.name)
                                 for f in dataclasses.fields(leaf)]))
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass
class StepCount:
    """What ``StepCounter`` and ``FlopCounterMode`` saw of one step."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    # (kind, group size, result bytes) of every collective, in order
    collective_log: List[Tuple[str, int, int]] = field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    n_ops: int = 0
    seconds: float = 0.0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def memory(self) -> Dict[str, int]:
        """The JAX package's ``memory_analysis`` keys."""
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "peak_hbm_est": self.argument_bytes + self.temp_bytes}


class StepCounter(TorchDispatchMode):
    """Counts bytes accessed, collectives and live storages (see the
    module docstring).  ``track_memory=False`` counts collectives and bytes
    only."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.count = StepCount()
        self.track_memory = track_memory
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._held: Dict[int, int] = {}

    # -- memory -------------------------------------------------------------
    def _free(self, key: int) -> None:
        n = self._live.pop(key, None)
        if n is not None:
            self._live_bytes -= n
        # an argument the step dropped (a decode state replaced): its
        # address may come back as a new storage, which is no argument
        self._held.pop(key, None)

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        weakref.finalize(st, self._free, key)
        if self._live_bytes > self.count.peak_bytes:
            self.count.peak_bytes = self._live_bytes

    def hold(self, tree: Any) -> None:
        """Register the step's arguments (every tensor in ``tree``): live
        from the start, counted as ``argument_bytes``."""
        for t in _tensors(tree):
            key = _storage_key(t)
            if key not in self._held:
                self._held[key] = t.untyped_storage().nbytes()
            self._see(t)
        self.count.argument_bytes = sum(self._held.values())

    def outputs(self, tree: Any) -> None:
        """Split the step's results into new (``output_bytes``) and
        argument storages written in place (``alias_bytes``)."""
        seen = set()
        for t in _tensors(tree):
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            if key in self._held:
                self.count.alias_bytes += n
            else:
                self.count.output_bytes += n

    # -- dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":    # metadata (a fake tensor's device)
            return out
        c = self.count
        c.n_ops += 1
        if func.namespace == "c10d":
            self._collective(func, args)
        elif not func.is_view:
            seen = set()
            total = 0
            for t in _tensors((args, kwargs, out)):
                if id(t) not in seen:
                    seen.add(id(t))
                    total += _nbytes(t)
            c.bytes_accessed += total
        if self.track_memory:
            for t in _tensors(out):
                self._see(t)
        return out

    def _collective(self, func, args) -> None:
        name = func._opname
        if name in C10D_SILENT:
            return
        kind = C10D_KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"the dry run has no ring model for "
                                      f"c10d.{name}")
        n = _group_size(args)
        # the first argument holds the result: the reduced or broadcast
        # tensors, the gathered outputs, the scattered shard, the sent
        result = sum(_nbytes(t) for t in _tensors(args[0]))
        if n > 1:
            self.count.collective_log.append((kind, n, result))
        self.count.collectives.add(kind, result, n)


def count_step(fn, args: Any, *,
               track_memory: bool = True) -> Tuple[Any, StepCount]:
    """Run ``fn(*args)`` under ``FlopCounterMode`` and a ``StepCounter``
    holding ``args``; returns ``(fn's result, the count)``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = StepCounter(track_memory=track_memory)
    counter.hold(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, counter:
        out = fn(*args)
    counter.count.seconds = time.perf_counter() - t0
    counter.count.flops = float(flops.get_total_flops())
    counter.outputs(out)
    return out, counter.count
