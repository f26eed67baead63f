"""Public wrapper around the itemset-counting CUDA kernels.

``itemset_counts`` / ``itemset_counts_into`` keep the JAX package's contract:
(N, W) uint32 bitmaps, (K, W) uint32 targets, (N, C) int32 weights (1-D
weights are promoted to (N, 1)), (K, C) int32 counts; ``k == 0`` and
``n == 0`` return without a launch.

``block_k`` / ``block_n`` / ``accum`` left as None resolve eagerly through
the active tuning table (``roofline.autotune.resolve_launch_config``), which
falls back to the compiled-in defaults below.  ``accum`` picks the route of
the weighted reduction:

  * ``"vpu_int32"``: ``csrc/itemset_count.cu`` (K1), int32 adds on the CUDA
    cores;
  * ``"mxu_f32"``: ``csrc/itemset_count_mxu.cu`` (K2), the reduction as an
    exact int8 product on the tensor cores.  Its contract is the JAX
    package's f32 route: refused with a ``ValueError`` for N >= 2^24 rows
    per launch.

Which code runs is decided by the tensors alone:

  * a CUDA tensor with ``use_kernel=True`` launches the route's kernel
    (built by ``nvcc`` at first use) or raises;
  * a CPU tensor, or ``use_kernel=False``, runs the route's plain PyTorch
    version in ``ref.py`` — both are explicit requests of the caller.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import torch

from ... import obs
from ...roofline import autotune
from ...roofline.kernel_model import record_launch
from .ref import (check_accum, check_inputs, itemset_counts_ref,
                  itemset_counts_ref_blocked)

__all__ = ["itemset_counts", "itemset_counts_into", "itemset_counts_ref",
           "itemset_counts_ref_blocked", "flush_timings"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "itemset_count.cu"             # K1 (+ K3 by its flag)
SOURCE_MXU = _CSRC / "itemset_count_mxu.cu"     # K2 (+ K3 by its flag)
# accum route -> (source, C entry point)
_ROUTES = {"vpu_int32": (SOURCE, "itemset_count_launch"),
           "mxu_f32": (SOURCE_MXU, "itemset_count_mxu_launch")}

# Compiled-in launch defaults (the autotuner's fallback): targets per CTA
# (one thread each) and rows staged in shared memory per step.
DEFAULT_BLOCK_K = autotune.DEFAULT_BLOCK_K
DEFAULT_BLOCK_N = autotune.DEFAULT_BLOCK_N
DEFAULT_ACCUM = autotune.DEFAULT_ACCUM

# The JAX package's f32 route is exact only below 2^24 rows per launch.
MXU_MAX_ROWS = autotune.MXU_MAX_ROWS

# Launches of the CUDA kernels in this process, in all and per accum route
# (plain-version calls do not count).
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_BY_ACCUM = {"vpu_int32": 0, "mxu_f32": 0}

_FNS: dict = {}

# Timed launches whose end event has not been read yet: (start, end, n, k,
# w, c).  Reading an event never waits on the launch stream unless asked to,
# so timing does not serialize a pipelined sweep.
_PENDING: List[tuple] = []


def _launcher(accum: str):
    """The route's C entry point (both take the same argument list)."""
    fn = _FNS.get(accum)
    if fn is None:
        from .._build import load

        source, name = _ROUTES[accum]
        fn = getattr(load(source), name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[accum] = fn
    return fn


def build() -> None:
    """Build both kernel libraries now (one ``nvcc`` each, in parallel) and
    load them; otherwise each route's first launch builds its own."""
    from .._build import build_all

    build_all(source for source, _ in _ROUTES.values())
    for accum in _ROUTES:
        _launcher(accum)


def flush_timings(wait: bool = True) -> None:
    """Publish the device time of timed launches to the telemetry
    (``record_launch``), oldest first.  ``wait=False`` takes only launches
    that have finished; ``wait=True`` waits for the rest.  Telemetry reads
    (``obs.snapshot``) flush with waiting."""
    while _PENDING and (wait or _PENDING[0][1].query()):
        start, end, n, k, w, c = _PENDING.pop(0)
        end.synchronize()
        record_launch(n, k, w, c, start.elapsed_time(end) / 1e3)


obs.register_flush(flush_timings)


def _launch(out: torch.Tensor, tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
            weights: torch.Tensor, *, block_k: int, block_n: int, accum: str,
            accumulate: bool) -> None:
    """One launch of ``accum``'s kernel on the current stream writing (or
    adding into) ``out``; bracketed with CUDA events when kernel timing is
    on, read later without waiting (``flush_timings``)."""
    global KERNEL_LAUNCHES
    dev = tx_bits.device
    for name, t in (("tgt_bits", tgt_bits), ("weights", weights),
                    ("out", out)):
        if t.device != dev:
            raise ValueError(f"itemset_counts: {name} on {t.device}, "
                             f"tx_bits on {dev}")
    if not 1 <= block_k <= 1024 or block_n < 1:
        raise ValueError(f"itemset_counts: block_k must be in [1, 1024] and "
                         f"block_n >= 1, got block_k={block_k} "
                         f"block_n={block_n}")
    n, w = tx_bits.shape
    k, c = tgt_bits.shape[0], weights.shape[1]
    launch = _launcher(accum)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        timed = obs.kernel_timing_enabled()
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = launch(
            tx_bits.data_ptr(), tgt_bits.data_ptr(), weights.data_ptr(),
            out.data_ptr(), n, k, w, c, block_k, block_n, int(accumulate),
            stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"itemset_count kernel ({accum}) launch failed "
                               f"with cudaError {err} at (N={n}, K={k}, "
                               f"W={w}, C={c})")
        KERNEL_LAUNCHES += 1
        KERNEL_LAUNCHES_BY_ACCUM[accum] += 1
        if timed:
            end.record(stream)
            _PENDING.append((start, end, n, k, w, c))
            flush_timings(wait=False)


def _counts(acc: Optional[torch.Tensor], tx_bits, tgt_bits, weights, *,
            block_k, block_n, use_kernel, accum) -> torch.Tensor:
    if weights.ndim == 1:
        weights = weights[:, None]
    n, w = tx_bits.shape
    k = tgt_bits.shape[0]
    c = weights.shape[1]
    if accum is not None:
        check_accum(accum)
    if k == 0 or n == 0:
        if acc is not None:
            return acc
        return torch.zeros((k, c), dtype=torch.int32, device=tx_bits.device)
    check_inputs(tx_bits, tgt_bits, weights, "itemset_counts")
    if block_k is None or block_n is None or accum is None:
        # eager host-side resolution on the concrete geometry
        cfg = autotune.resolve_launch_config(n, k, w, c)
        block_k = cfg.block_k if block_k is None else block_k
        block_n = cfg.block_n if block_n is None else block_n
        accum = cfg.accum if accum is None else accum
    if accum == "mxu_f32" and n >= MXU_MAX_ROWS:
        # the JAX package's exactness contract for its f32 route: a real
        # error with the geometry, raised before any device work
        raise ValueError(
            "mxu_f32 accumulation is exact only for N < 2^24 rows per "
            f"launch; got geometry (N={n}, K={k}, W={w}, C={c}) — chunk "
            "the sweep (mining/stream.py) or use accum='vpu_int32'")
    if tx_bits.device.type == "cpu" or not use_kernel:
        part = itemset_counts_ref_blocked(tx_bits, tgt_bits, weights,
                                          accum=accum)
        if acc is None:
            return part
        acc += part
        return acc
    if tx_bits.device.type != "cuda":
        raise ValueError(f"itemset_counts: no kernel for device "
                         f"{tx_bits.device}")
    tx_bits = tx_bits.contiguous()
    tgt_bits = tgt_bits.contiguous()
    weights = weights.to(torch.int32).contiguous()
    out = acc
    if out is None:
        out = torch.empty((k, c), dtype=torch.int32, device=tx_bits.device)
    elif (out.dtype != torch.int32 or tuple(out.shape) != (k, c)
          or not out.is_contiguous()):
        raise ValueError(f"itemset_counts_into: acc must be a contiguous "
                         f"({k}, {c}) int32 tensor, got {out.dtype} "
                         f"{tuple(out.shape)}")
    span = obs.TRACER.span("kernel.count", {"n": n, "k": k, "w": w, "c": c,
                                            "accum": accum})
    with span:
        _launch(out, tx_bits, tgt_bits, weights, block_k=block_k,
                block_n=block_n, accum=accum, accumulate=acc is not None)
    return out


def itemset_counts(
    tx_bits: torch.Tensor,     # (N, W) uint32
    tgt_bits: torch.Tensor,    # (K, W) uint32
    weights: torch.Tensor,     # (N, C) int32  (or (N,) -> C=1)
    *,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    use_kernel: bool = True,
    accum: Optional[str] = None,
) -> torch.Tensor:             # (K, C) int32
    """Exact counts of every target itemset, per weight column (class).

    ``block_k`` (targets per CTA, one thread each) and ``block_n`` (rows
    staged in shared memory per step; K2 stages a fixed 128) left as None,
    and ``accum`` left as None, resolve through the active tuning table.
    ``accum`` is ``'vpu_int32'`` (K1: the integer reduction on the CUDA
    cores) or ``'mxu_f32'`` (K2: the reduction on the tensor cores; N < 2^24
    rows).  No choice changes the counts."""
    return _counts(None, tx_bits, tgt_bits, weights, block_k=block_k,
                   block_n=block_n, use_kernel=use_kernel, accum=accum)


def itemset_counts_into(
    acc: torch.Tensor,            # (K, C) int32 running counts, updated in place
    tx_bits: torch.Tensor,        # (N_chunk, W) uint32
    tgt_bits: torch.Tensor,       # (K, W) uint32
    weights: torch.Tensor,        # (N_chunk, C) int32
    *,
    block_k: Optional[int] = None,
    block_n: Optional[int] = None,
    use_kernel: bool = True,
    accum: Optional[str] = None,
) -> torch.Tensor:                # (K, C) int32 = acc + chunk counts
    """``acc += itemset_counts(chunk)``, in place, and return ``acc``.

    On the card the kernel adds into ``acc`` directly, so a sweep allocates
    no output per chunk (the JAX package donates the accumulator to the
    same effect)."""
    return _counts(acc, tx_bits, tgt_bits, weights, block_k=block_k,
                   block_n=block_n, use_kernel=use_kernel, accum=accum)
