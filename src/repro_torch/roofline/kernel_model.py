"""Roofline model of the ``itemset_count`` CUDA kernels, per launch geometry.

The counting kernel computes, for (N, W) bitmap rows, (K, W) targets and
(N, C) weights, ``counts[k, c] = sum_n w[n, c] * [row n contains target k]``.
Its bound is the least time the card could take for that function: the
larger of the bytes it must move and the operations it must do.

  bytes = 4 * (N*W + N*C + K*W + K*C)       each input read once, the (K, C)
                                            result written once
  ops   = ceil(N/32) * sum_k floor(s_k/2)   the containment test, bit-sliced
          + C * hits                        (32 rows per word): a target of
                                            s_k items is the AND of its s_k
                                            item-column words,
                                            ceil((s_k - 1)/2) = floor(s_k/2)
                                            three-input LOP3s per 32 rows;
                                            C adds per contained pair

``hits`` is the number of contained (row, target) pairs and ``s_k`` the
number of items of target k, both data: a caller that knows them
(``chip_smoke.py`` counts them) passes them.  The telemetry path
(``record_launch``) knows neither, so its prediction counts one AND per
target and row-word and no adds, a floor that never flatters a launch.

The model's first form counted the work of the *horizontal* formulation,
one LOP3 per word for every (row, target) pair: ``N*K*W + C*hits``
(``horizontal_flops``, kept to compare with the times it was quoted
beside).  That is the work of a kernel that reads rows one at
a time, not the least work of the function: the bit-sliced K1
(``csrc/itemset_count.cu``) runs below it, and a kernel/bound ratio under 1
would show the count wrong, not the kernel fast.  The JAX package's model
charges N*K*(2W + C), three times the horizontal count at W = C = 2.

Predicted launch time is the perfect-overlap roofline bound
``max(bytes/HBM_BW, ops/PEAK_INT32_OPS)`` with the H100 SXM constants below.

``accum="mxu_f32"`` (K2, ``csrc/itemset_count_mxu.cu``) moves the weighted
reduction to the tensor cores as an int8 product over the weights' 4 byte
planes: the integer pipe keeps the containment test (no per-hit adds), and
the tensor cores do ``2*N*K*4C`` int8 operations.  Its bound is the larger
of the three times: at the main-path level 3 (N = 969,130, K = 34,220,
W = C = 2, three items a target) about 0.06 ms of containment against
0.27 ms of tensor work, so K2's bound is its tensor term.

``record_launch`` publishes measured device time against that prediction
into the telemetry registry (``repro_torch.obs``), so a run reports a
measured-vs-predicted efficiency ratio per geometry.

Constants (NVIDIA H100 SXM, at the full 700 W power limit):

  * ``HBM_BW`` = 3.35e12 B/s, the data-sheet HBM3 rate.
  * ``PEAK_INT32_OPS`` = 132 SMs x 64 INT32 lanes per SM x 1.98e9 Hz
    = 1.67e13 32-bit integer op/s.  A Hopper SM has 64 INT32 lanes (16 per
    scheduler partition) beside its 128 FP32 lanes; LOP3 and the integer
    compare issue only to the INT32 lanes, so that is their rate.  1.98 GHz
    is the card's maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``
    reads 1980 MHz on the H100 SXM).  A card set below 700 W clocks lower
    under load, so the bound is optimistic there.
  * ``PEAK_INT8_TENSOR_OPS`` = 1.979e15 op/s, the published dense int8
    tensor-core rate of the H100 SXM (NVIDIA's data sheet, without
    sparsity).
"""
from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

HBM_BW = 3.35e12                          # B/s
SM_COUNT = 132
INT32_LANES_PER_SM = 64
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_INT32_OPS = SM_COUNT * INT32_LANES_PER_SM * MAX_SM_CLOCK_HZ  # op/s
PEAK_INT8_TENSOR_OPS = 1.979e15           # op/s, dense int8 tensor cores

_WORD_BYTES = 4


def and_ops(n: int, k: int, target_sizes: Optional[Iterable[int]] = None
            ) -> float:
    """Three-input ANDs of the bit-sliced containment test: floor(s/2) per
    target of s items and row-word of 32 rows; one per target and row-word
    when the sizes are not known."""
    words = float(-(-int(n) // 32))
    if target_sizes is None:
        return words * float(k)
    return words * float(sum(int(s) // 2 for s in target_sizes))


def kernel_flops(n: int, k: int, w: int, c: int, hits: int = 0,
                 target_sizes: Optional[Iterable[int]] = None) -> float:
    """Integer operations one count needs: the bit-sliced containment test
    (``and_ops``) plus the C adds of each of ``hits`` contained pairs."""
    return and_ops(n, k, target_sizes) + float(c) * float(hits)


def horizontal_flops(n: int, k: int, w: int, c: int, hits: int = 0) -> float:
    """The horizontal count: one LOP3 per word for every (row, target) pair
    plus the C adds of each contained pair."""
    return float(n) * float(k) * float(w) + float(c) * float(hits)


def tensor_ops(n: int, k: int, c: int) -> float:
    """Int8 tensor-core operations of K2's reduction: a (K, N) x (N, 4C)
    product, two operations per multiply-add."""
    return 2.0 * float(n) * float(k) * 4.0 * float(c)


def kernel_bytes(n: int, k: int, w: int, c: int) -> float:
    """HBM traffic of one sweep: bitmap + weights + targets + result."""
    return _WORD_BYTES * (float(n) * w + float(n) * c
                          + float(k) * w + float(k) * c)


def _times(n: int, k: int, w: int, c: int, hits: int, accum: str,
           target_sizes: Optional[Iterable[int]]):
    """(integer-pipe, tensor-core, memory) seconds of one launch."""
    if accum == "mxu_f32":
        return (and_ops(n, k, target_sizes) / PEAK_INT32_OPS,
                tensor_ops(n, k, c) / PEAK_INT8_TENSOR_OPS,
                kernel_bytes(n, k, w, c) / HBM_BW)
    return (kernel_flops(n, k, w, c, hits, target_sizes) / PEAK_INT32_OPS, 0.0,
            kernel_bytes(n, k, w, c) / HBM_BW)


def predicted_seconds(n: int, k: int, w: int, c: int, hits: int = 0,
                      accum: str = "vpu_int32",
                      target_sizes: Optional[Iterable[int]] = None) -> float:
    """Perfect-overlap roofline bound for one launch on the card.  ``hits``
    counts only for ``vpu_int32``: K2 adds no weights on the integer
    pipe."""
    return max(_times(n, k, w, c, hits, accum, target_sizes))


def horizontal_seconds(n: int, k: int, w: int, c: int, hits: int = 0
                       ) -> float:
    """The horizontal bound: ``horizontal_flops`` against the same
    bytes."""
    return max(horizontal_flops(n, k, w, c, hits) / PEAK_INT32_OPS,
               kernel_bytes(n, k, w, c) / HBM_BW)


# -- geometry bucketing ------------------------------------------------------
#
# Telemetry labels and tuning-table keys are BUCKETIZED geometries: each
# dimension rounds UP to a power of two inside a clamped range, so however
# adversarial the query mix (one distinct N per append, one distinct K per
# query shape) the label set stays bounded and the metrics registry cannot
# grow without limit.  The roofline PREDICTION still uses the exact geometry
# — only the label under which it is aggregated is rounded.  A hard cap
# backstops the clamp: once ``MAX_GEOMETRY_BUCKETS`` distinct buckets exist,
# any new bucket collapses into the single ``GEOMETRY_OVERFLOW`` label.

_BUCKET_RE = re.compile(r"n(\d+)_k(\d+)_w(\d+)_c(\d+)")
_BUCKET_RANGES = ((128, 1 << 26),   # n
                  (8, 1 << 20),     # k
                  (1, 64),          # w: widest register-resident target
                  (1, 16))          # c: class columns
MAX_GEOMETRY_BUCKETS = 256
GEOMETRY_OVERFLOW = "overflow"
_SEEN_BUCKETS: set = set()


def _bucket_dim(x: int, lo: int, hi: int) -> int:
    x = max(int(x), 1)
    p2 = 1 << (x - 1).bit_length()     # round up to a power of two
    return min(max(p2, lo), hi)


def geometry_bucket(n: int, k: int, w: int, c: int) -> str:
    """Bucketized geometry label: pow2-rounded, range-clamped dimensions."""
    bn, bk, bw, bc = (_bucket_dim(x, lo, hi)
                      for x, (lo, hi) in zip((n, k, w, c), _BUCKET_RANGES))
    return f"n{bn}_k{bk}_w{bw}_c{bc}"


def bucket_shape(bucket: str) -> Tuple[int, int, int, int]:
    """Parse ``"nN_kK_wW_cC"`` back to ``(n, k, w, c)`` (ValueError if not
    a geometry bucket — e.g. the overflow label)."""
    m = _BUCKET_RE.fullmatch(bucket)
    if m is None:
        raise ValueError(f"not a geometry bucket label: {bucket!r}")
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


def _bucket_label(n: int, k: int, w: int, c: int) -> str:
    """Bucket label with the hard cardinality cap applied."""
    b = geometry_bucket(n, k, w, c)
    if b in _SEEN_BUCKETS:
        return b
    if len(_SEEN_BUCKETS) >= MAX_GEOMETRY_BUCKETS:
        return GEOMETRY_OVERFLOW
    _SEEN_BUCKETS.add(b)
    return b


def _reset_geometry_buckets() -> None:
    """Drop the seen-bucket cap state (tests only)."""
    _SEEN_BUCKETS.clear()


def bound_by(n: int, k: int, w: int, c: int, hits: int = 0,
             accum: str = "vpu_int32",
             target_sizes: Optional[Iterable[int]] = None) -> str:
    """Which side of the roofline bounds this geometry: ``"operations"`` or
    ``"bytes"``."""
    int_s, tensor_s, mem_s = _times(n, k, w, c, hits, accum, target_sizes)
    return "operations" if max(int_s, tensor_s) >= mem_s else "bytes"


def record_launch(n: int, k: int, w: int, c: int, seconds: float) -> None:
    """Publish one measured launch against the model: three counters per
    geometry BUCKET (launch count, measured seconds, predicted seconds) —
    the efficiency ratio is derived at snapshot time by
    ``repro_torch.obs.kernel_efficiency``.  The prediction uses the exact
    geometry and counts the containment test alone, one AND per target and
    row-word (the wrapper reads neither the hit count nor the targets'
    sizes back); only the aggregation label is bucketized (bounded label
    set)."""
    from ..obs import REGISTRY

    geom = _bucket_label(n, k, w, c)
    REGISTRY.counter("kernel_launches_total", geometry=geom).inc()
    REGISTRY.counter("kernel_measured_s_total", geometry=geom).inc(seconds)
    REGISTRY.counter("kernel_predicted_s_total", geometry=geom).inc(
        predicted_seconds(n, k, w, c))
