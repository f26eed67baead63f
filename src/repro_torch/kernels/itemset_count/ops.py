"""Public wrapper around the itemset-counting CUDA kernels.

``itemset_counts`` / ``itemset_counts_into`` keep the JAX package's contract:
(N, W) uint32 bitmaps, (K, W) uint32 targets, (N, C) int32 weights (1-D
weights are promoted to (N, 1)), (K, C) int32 counts; ``k == 0`` and
``n == 0`` return without a launch.

``block_k`` / ``block_n`` / ``accum`` left as None resolve eagerly through
the active tuning table (``roofline.autotune.resolve_launch_config``), which
falls back to the compiled-in defaults below.  ``accum`` picks the route of
the weighted reduction:

  * ``"vpu_int32"``: ``csrc/itemset_count.cu`` (K1), bit-sliced: a layout
    pass turns the rows into item columns and the weights into odd planes
    and a heavy-row column (32 rows per word) in a scratch buffer the
    wrapper keeps per stream (sized by the kernel library's
    ``sliced_geometry``), then the count kernel ANDs each target's columns
    and adds popcounts on the CUDA cores;
  * ``"mxu_f32"``: ``csrc/itemset_count_mxu.cu`` (K2), the same layout
    pass with each class's 32 weight bit planes, then a count kernel that
    ANDs each target's item columns and reduces them against the live
    planes as an exact b1 AND + POPC product on the tensor cores.  Its
    contract is the JAX package's f32 route: refused with a ``ValueError``
    for N >= 2^24 rows per launch.

Both routes' layouts, their stage geometry and the layout pass live in
``csrc/bitslice.cuh``; the wrapper asks each route's kernel library for
its sizes (``sliced_geometry``).

Which code runs is decided by the tensors alone:

  * a CUDA tensor with ``use_kernel=True`` launches the route's kernel
    (built by ``nvcc`` at first use) or raises;
  * a CPU tensor, or ``use_kernel=False``, runs the route's plain PyTorch
    version in ``ref.py`` — both are explicit requests of the caller.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import torch

from ... import obs
from ...roofline import autotune
from ...roofline.kernel_model import record_launch
from .ref import (check_accum, check_inputs, heavy_rows,
                  itemset_counts_ref, itemset_counts_ref_blocked,
                  to_item_columns, to_weight_planes, whole_masks)

__all__ = ["itemset_counts", "itemset_counts_into", "itemset_counts_ref",
           "itemset_counts_ref_blocked", "bit_slice", "sliced_geometry",
           "flush_timings"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "itemset_count.cu"             # K1 (+ K3 by its flag)
SOURCE_MXU = _CSRC / "itemset_count_mxu.cu"     # K2 (+ K3 by its flag)
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# tx, tgt, wts, out, scratch, scratch words, n, k, w, c, block_k, block_n,
# accumulate, stream
_LAUNCH_ARGS = [_P] * 5 + [_LL] * 3 + [_I] * 5 + [_P]
# tx, wts, scratch, scratch words, n, w, c, block_n, stream
_LAYOUT_ARGS = [_P] * 3 + [_LL] * 2 + [_I] * 3 + [_P]
# accum route -> (source, its count entry point, its layout pass alone, the
# route's number in the geometry)
_ROUTES = {
    "vpu_int32": (SOURCE, "itemset_count_launch", "itemset_count_layout", 0),
    "mxu_f32": (SOURCE_MXU, "itemset_count_mxu_launch",
                "itemset_count_mxu_layout", 1),
}
# Each library's layout geometry: n, w, c, block_n, route, out (9 long longs)
_GEOMETRY = ("itemset_count_geometry",
             [_LL] + [_I] * 4 + [ctypes.POINTER(_LL)])

# Compiled-in launch defaults (the autotuner's fallback): targets per CTA
# (one thread each) and rows per stage.
DEFAULT_BLOCK_K = autotune.DEFAULT_BLOCK_K
DEFAULT_BLOCK_N = autotune.DEFAULT_BLOCK_N
DEFAULT_ACCUM = autotune.DEFAULT_ACCUM

# The JAX package's f32 route is exact only below 2^24 rows per launch.
MXU_MAX_ROWS = autotune.MXU_MAX_ROWS

# Launches of the CUDA kernels in this process, in all, per accum route, and
# those that add into a running count (K3: ``itemset_counts_into``; also in
# the other two); plain-version calls do not count.
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_BY_ACCUM = {"vpu_int32": 0, "mxu_f32": 0}
KERNEL_LAUNCHES_INTO = 0

_FNS: dict = {}

# Timed launches whose end event has not been read yet: (start, end, n, k,
# w, c, accum).  Reading an event never waits on the launch stream unless
# asked to, so timing does not serialize a pipelined sweep.
_PENDING: List[tuple] = []


def _c_function(source: Path, name: str, argtypes: list):
    fn = _FNS.get((source, name))
    if fn is None:
        from .._build import load

        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(source, name)] = fn
    return fn


def _launcher(accum: str):
    """The route's count entry point."""
    source, name, _, _ = _ROUTES[accum]
    return _c_function(source, name, _LAUNCH_ARGS)


def _layout_pass(accum: str):
    """The route's layout pass alone."""
    source, _, name, _ = _ROUTES[accum]
    return _c_function(source, name, _LAYOUT_ARGS)


class SlicedGeometry(NamedTuple):
    """The bit-sliced layout of one launch, in uint32 words, as the kernel
    sources define it (``csrc/bitslice.cuh``, reported by
    ``itemset_count_geometry``); offsets a route does not have are -1."""
    stage_words: int    # row-words (32 rows each) per stage
    stages: int
    padded_words: int   # row-words, padded to whole stages
    words: int          # the scratch's length
    heavy: int          # K1: offset of the heavy column
    odd: int            # K1: offset of the first class's odd plane
    live: int           # offset of the live masks
    planes: int         # K2: offset of the first class's 32 planes
    whole: int          # K2: offset of the whole-launch masks


@functools.lru_cache(maxsize=1024)
def sliced_geometry(n: int, w: int, c: int, block_n: int,
                    accum: str = "vpu_int32") -> SlicedGeometry:
    """``accum``'s layout of ``n`` rows of ``w`` words and ``c`` classes for
    ``block_n``, from the route's kernel library (built at first use)."""
    check_accum(accum)
    source, _, _, route = _ROUTES[accum]
    out = (_LL * 9)()
    err = _c_function(source, *_GEOMETRY)(n, w, c, block_n, route, out)
    if err != 0:
        raise ValueError(f"itemset_count geometry: cudaError {err} at "
                         f"(N={n}, W={w}, C={c}, block_n={block_n}, "
                         f"accum={accum})")
    return SlicedGeometry(*out)


# One layout scratch per (device, stream, thread), grown when a launch needs
# more and reused by every later launch there: one thread's launches on one
# stream run in order, so none overwrites a scratch that an earlier one
# still reads (two threads' launches may interleave on a stream, hence one
# scratch each), and a sweep allocates nothing per chunk.  It holds the
# largest layout launched there.
_SCRATCH: dict = {}


def _scratch(words: int, stream) -> torch.Tensor:
    key = (stream.device, stream.cuda_stream, threading.get_ident())
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.empty(words, dtype=torch.int32, device=stream.device)
        _SCRATCH[key] = buf
    return buf[:words]


def build() -> None:
    """Build both kernel libraries now (one ``nvcc`` each, in parallel) and
    load them; otherwise each route's first launch builds its own."""
    from .._build import build_all

    build_all(source for source, _, _, _ in _ROUTES.values())
    for accum, (source, _, _, _) in _ROUTES.items():
        _launcher(accum)
        _layout_pass(accum)
        _c_function(source, *_GEOMETRY)


def flush_timings(wait: bool = True) -> None:
    """Publish the device time of timed launches to the telemetry
    (``record_launch``), oldest first.  ``wait=False`` takes only launches
    that have finished; ``wait=True`` waits for the rest.  Telemetry reads
    (``obs.snapshot``) flush with waiting."""
    while _PENDING and (wait or _PENDING[0][1].query()):
        start, end, n, k, w, c, accum = _PENDING.pop(0)
        end.synchronize()
        record_launch(n, k, w, c, start.elapsed_time(end) / 1e3, accum)


obs.register_flush(flush_timings)


def _launch(out: torch.Tensor, tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
            weights: torch.Tensor, *, block_k: int, block_n: int, accum: str,
            accumulate: bool) -> None:
    """One launch of ``accum``'s kernel on the current stream writing (or
    adding into) ``out``; bracketed with CUDA events when kernel timing is
    on, read later without waiting (``flush_timings``)."""
    global KERNEL_LAUNCHES, KERNEL_LAUNCHES_INTO
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
        words = sliced_geometry(n, w, c, block_n, accum).words
        err = launch(tx_bits.data_ptr(), tgt_bits.data_ptr(),
                     weights.data_ptr(), out.data_ptr(),
                     _scratch(words, stream).data_ptr(), words, n, k, w, c,
                     block_k, block_n, int(accumulate), stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"itemset_count kernel ({accum}) launch failed "
                               f"with cudaError {err} at (N={n}, K={k}, "
                               f"W={w}, C={c})")
        KERNEL_LAUNCHES += 1
        KERNEL_LAUNCHES_BY_ACCUM[accum] += 1
        KERNEL_LAUNCHES_INTO += int(accumulate)
        if timed:
            end.record(stream)
            _PENDING.append((start, end, n, k, w, c, accum))
            flush_timings(wait=False)


class BitSliced(NamedTuple):
    """K1's bit-sliced layout, uint32: ``columns`` (32W + 1, words), the
    classes' ``odd`` planes (C, words), the ``heavy`` column (words,) and
    the ``live`` masks (C, stages) of stages of ``stage_words`` row-words."""
    columns: torch.Tensor
    odd: torch.Tensor
    heavy: torch.Tensor
    live: torch.Tensor
    stage_words: int


class PlaneSliced(NamedTuple):
    """K2's bit-sliced layout, uint32: ``columns`` (32W + 1, words), every
    class's 32 weight ``planes`` (C, 32, words), the ``live`` masks (C,
    stages) of stages of ``stage_words`` row-words and the ``whole``-launch
    masks (C,)."""
    columns: torch.Tensor
    planes: torch.Tensor
    live: torch.Tensor
    whole: torch.Tensor
    stage_words: int


def bit_slice(tx_bits: torch.Tensor, weights: torch.Tensor, *,
              block_n: int = DEFAULT_BLOCK_N, accum: str = "vpu_int32"):
    """``accum``'s bit-sliced layout of ``(tx_bits, weights)`` for
    ``block_n``: a ``BitSliced`` for K1 (``vpu_int32``), a ``PlaneSliced``
    for K2 (``mxu_f32``).

    On a CUDA tensor it runs the route's layout pass alone (on the current
    stream; not counted in ``KERNEL_LAUNCHES``, which counts whole counts):
    the kernel's stage (``sliced_geometry``) and its words padded to whole
    stages, pad rows zero.  On the CPU it is the plain version
    (``ref.to_item_columns``; ``ref.to_weight_planes`` and its live masks;
    K1's plane 0 and ``ref.heavy_rows``, K2's ``ref.whole_masks``) over
    ``ceil(N / 32)`` words, with stages of ``ceil(block_n / 32)``
    row-words."""
    check_accum(accum)
    if weights.ndim == 1:
        weights = weights[:, None]
    n, w = tx_bits.shape
    c = weights.shape[1]
    if n == 0:
        raise ValueError("bit_slice: no rows")
    mxu = accum == "mxu_f32"
    if tx_bits.device.type == "cpu":
        sw = -(-block_n // 32)
        planes, live = to_weight_planes(weights, sw)
        if mxu:
            return PlaneSliced(to_item_columns(tx_bits), planes, live,
                               whole_masks(weights), sw)
        return BitSliced(to_item_columns(tx_bits), planes[:, 0],
                         heavy_rows(planes), live, sw)
    tx_bits = tx_bits.contiguous()
    weights = weights.to(torch.int32).contiguous()
    g = sliced_geometry(n, w, c, block_n, accum)
    scratch = torch.empty(g.words, dtype=torch.int32, device=tx_bits.device)
    with torch.cuda.device(tx_bits.device):
        stream = torch.cuda.current_stream(tx_bits.device)
        err = _layout_pass(accum)(tx_bits.data_ptr(), weights.data_ptr(),
                                  scratch.data_ptr(), g.words, n, w, c,
                                  block_n, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"itemset_count layout pass ({accum}) failed with "
                           f"cudaError {err} at (N={n}, W={w}, C={c})")
    words = scratch.view(torch.uint32)
    nwp = g.padded_words
    columns = words[:(32 * w + 1) * nwp].view(32 * w + 1, nwp)
    live = words[g.live:g.live + c * g.stages].view(c, g.stages)
    if mxu:
        return PlaneSliced(columns, words[g.planes:g.live].view(c, 32, nwp),
                           live, words[g.whole:g.whole + c], g.stage_words)
    return BitSliced(columns, words[g.odd:g.live].view(c, nwp),
                     words[g.heavy:g.heavy + nwp], live, g.stage_words)


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

    ``block_k`` (targets per CTA, any value in [1, 1024]) and ``block_n``
    (rows per stage of the bit-sliced sweep, rounded up to a multiple of
    128 rows for K1 and 1024 for K2 and cut to fit shared memory) left as
    None, and ``accum`` left as None, resolve through the active tuning
    table.
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
