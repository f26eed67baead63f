"""Public wrapper around the itemset-counting CUDA kernel.

``itemset_counts`` / ``itemset_counts_into`` keep the JAX package's contract:
(N, W) uint32 bitmaps, (K, W) uint32 targets, (N, C) int32 weights (1-D
weights are promoted to (N, 1)), (K, C) int32 counts; ``k == 0`` and
``n == 0`` return without a launch.

Which code runs is decided by the tensors alone:

  * a CUDA tensor with ``use_kernel=True`` launches the kernel in
    ``csrc/itemset_count.cu`` (built by ``nvcc`` at first use) or raises;
  * a CPU tensor, or ``use_kernel=False``, runs the plain PyTorch version in
    ``ref.py`` — both are explicit requests of the caller.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional

import torch

from ... import obs
from ...roofline.kernel_model import record_launch
from .ref import check_inputs, itemset_counts_ref, itemset_counts_ref_blocked

__all__ = ["itemset_counts", "itemset_counts_into", "itemset_counts_ref",
           "itemset_counts_ref_blocked", "flush_timings"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "itemset_count.cu"

# Compiled-in launch defaults: targets per CTA (one thread each) and rows
# staged in shared memory per step.  The tuning table arrives with the
# autotuner.
DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 512
DEFAULT_ACCUM = "vpu_int32"

# Launches of the CUDA kernel in this process (plain-version calls do not
# count).
KERNEL_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None

# Timed launches whose end event has not been read yet: (start, end, n, k,
# w, c).  Reading an event never waits on the launch stream unless asked to,
# so timing does not serialize a pipelined sweep.
_PENDING: List[tuple] = []


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .._build import load

        lib = load(SOURCE)
        lib.itemset_count_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.itemset_count_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel library now (otherwise the first launch
    does)."""
    _lib()


def _check_accum(accum: Optional[str]) -> None:
    accum = DEFAULT_ACCUM if accum is None else accum
    if accum == "mxu_f32":
        raise NotImplementedError(
            "accum='mxu_f32' (the tensor-core reduction, TPU kernel K2) is "
            "not ported yet: ROADMAP queue 2")
    if accum != "vpu_int32":
        raise ValueError(f"unknown accum {accum!r}; expected 'vpu_int32'")


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
            weights: torch.Tensor, *, block_k: int, block_n: int,
            accumulate: bool) -> None:
    """One kernel launch on the current stream writing (or adding into)
    ``out``; bracketed with CUDA events when kernel timing is on, read
    later without waiting (``flush_timings``)."""
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
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        timed = obs.kernel_timing_enabled()
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        err = lib.itemset_count_launch(
            tx_bits.data_ptr(), tgt_bits.data_ptr(), weights.data_ptr(),
            out.data_ptr(), n, k, w, c, block_k, block_n, int(accumulate),
            stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"itemset_count kernel launch failed with "
                               f"cudaError {err} at (N={n}, K={k}, W={w}, "
                               f"C={c})")
        KERNEL_LAUNCHES += 1
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
    _check_accum(accum)
    if k == 0 or n == 0:
        if acc is not None:
            return acc
        return torch.zeros((k, c), dtype=torch.int32, device=tx_bits.device)
    check_inputs(tx_bits, tgt_bits, weights, "itemset_counts")
    if tx_bits.device.type == "cpu" or not use_kernel:
        part = itemset_counts_ref_blocked(tx_bits, tgt_bits, weights)
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
    span = obs.TRACER.span("kernel.count", {"n": n, "k": k, "w": w, "c": c})
    with span:
        _launch(out, tx_bits, tgt_bits, weights,
                block_k=DEFAULT_BLOCK_K if block_k is None else block_k,
                block_n=DEFAULT_BLOCK_N if block_n is None else block_n,
                accumulate=acc is not None)
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
    staged in shared memory per step) left as None take the compiled-in
    defaults.  ``accum`` accepts ``'vpu_int32'`` (the integer reduction on
    the CUDA cores); ``'mxu_f32'`` is not ported yet and raises
    ``NotImplementedError``."""
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
