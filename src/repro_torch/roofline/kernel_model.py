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

``accum="mxu_f32"`` (K2, ``csrc/itemset_count_mxu.cu``) reduces the same
bit-sliced AND words on the tensor cores: with the weights split into their
32 two's-complement bit planes, a target's count is
``sum_b popc(h & plane_b) << b`` over the live planes, a b1 AND + POPC
product of ``2 * 32 * K * plane_words`` bit operations (``b1_ops``), where
``plane_words`` sums, over the row-words (32 rows each), the (class, bit)
planes live in that word: a plane none of whose 32 rows has the bit set
needs no product there.  A caller that knows the weights (``chip_smoke.py``
counts the nonzero words of ``ref.to_weight_planes``) passes it; the
telemetry path does not, and counts ``C`` planes in every word
(``C * ceil(N/32)``), a floor that never flatters.  K2's bound is the
larger of that product at ``PEAK_B1_TENSOR_OPS``, its ANDs (``and_ops``)
at ``PEAK_INT32_OPS``, and its bytes; it adds no weights on the integer
pipe.  The first K2 (a
row-by-row test) reduced the 0/1 containment bytes against the weights' 4
byte planes, ``2*N*K*4C`` int8 operations (``byte_plane_ops``,
``byte_plane_seconds``): the work of one formulation, not the least work
of the function, kept to compare with the times it was quoted beside.

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
  * ``PEAK_B1_TENSOR_OPS`` = 8 x ``PEAK_INT8_TENSOR_OPS`` = 1.5832e16 bit
    op/s: the card's tensor rate in bits.  No data sheet gives a b1 rate
    for Hopper; the rate loop of ``csrc/b1_probe.cu`` (every warp of 132 x
    4 CTAs of 8 warps issues chains of independent ``mma.sync``, timed with
    CUDA events through ``b1_probe.mma_rate``), as ``chip_smoke.py`` phase
    8 runs it, finds a b1 ``m16n8k256`` (256 bits of k) taking the time of a
    u8 ``m16n8k32`` (32 bytes of k) on an NVIDIA H100 80GB HBM3 at a 700.00
    W power limit (``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``), which ties the b1 rate to 8x the int8 rate.
    ``mma.sync`` itself reaches about two thirds of the int8 rate there
    (the rest needs ``wgmma``), so the bound counts what the card can do,
    not what one instruction reaches; the script prints the measured rate
    beside it.
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
# bit op/s of b1 AND+POPC: a b1 m16n8k256 issues at the rate of a u8
# m16n8k32 on the H100 (csrc/b1_probe.cu, see above)
PEAK_B1_TENSOR_OPS = 8 * PEAK_INT8_TENSOR_OPS

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


def b1_ops(k: int, plane_words: int) -> float:
    """Bit operations of K2's b1 product: ``plane_words`` live (class, bit)
    plane words of 32 rows each, two operations (AND, POPC-add) per bit and
    target."""
    return 2.0 * 32.0 * float(k) * float(plane_words)


def byte_plane_ops(n: int, k: int, c: int) -> float:
    """Int8 operations of the first K2's formulation: a (K, N) x (N, 4C)
    product of 0/1 containment bytes and the weights' byte planes."""
    return 2.0 * float(n) * float(k) * 4.0 * float(c)


def kernel_bytes(n: int, k: int, w: int, c: int) -> float:
    """HBM traffic of one sweep: bitmap + weights + targets + result."""
    return _WORD_BYTES * (float(n) * w + float(n) * c
                          + float(k) * w + float(k) * c)


def _times(n: int, k: int, w: int, c: int, hits: int, accum: str,
           target_sizes: Optional[Iterable[int]], plane_words: Optional[int]):
    """(integer-pipe, tensor-core, memory) seconds of one launch."""
    if accum == "mxu_f32":
        if plane_words is None:
            plane_words = c * -(-int(n) // 32)
        return (and_ops(n, k, target_sizes) / PEAK_INT32_OPS,
                b1_ops(k, plane_words) / PEAK_B1_TENSOR_OPS,
                kernel_bytes(n, k, w, c) / HBM_BW)
    return (kernel_flops(n, k, w, c, hits, target_sizes) / PEAK_INT32_OPS, 0.0,
            kernel_bytes(n, k, w, c) / HBM_BW)


def predicted_seconds(n: int, k: int, w: int, c: int, hits: int = 0,
                      accum: str = "vpu_int32",
                      target_sizes: Optional[Iterable[int]] = None,
                      plane_words: Optional[int] = None) -> float:
    """Perfect-overlap roofline bound for one launch on the card.  ``hits``
    counts only for ``vpu_int32`` and ``plane_words`` (the live plane
    words, ``C`` planes in every word when None) only for ``mxu_f32``: K2
    adds no weights on the integer pipe."""
    return max(_times(n, k, w, c, hits, accum, target_sizes, plane_words))


def byte_plane_seconds(n: int, k: int, w: int, c: int,
                       target_sizes: Optional[Iterable[int]] = None) -> float:
    """The first K2's bound: the byte-plane product at ``PEAK_INT8_TENSOR_OPS``
    against the same ANDs and bytes."""
    return max(and_ops(n, k, target_sizes) / PEAK_INT32_OPS,
               byte_plane_ops(n, k, c) / PEAK_INT8_TENSOR_OPS,
               kernel_bytes(n, k, w, c) / HBM_BW)


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
             target_sizes: Optional[Iterable[int]] = None,
             plane_words: Optional[int] = None) -> str:
    """Which side of the roofline bounds this geometry: ``"operations"`` or
    ``"bytes"``."""
    int_s, tensor_s, mem_s = _times(n, k, w, c, hits, accum, target_sizes,
                                    plane_words)
    return "operations" if max(int_s, tensor_s) >= mem_s else "bytes"


def record_launch(n: int, k: int, w: int, c: int, seconds: float,
                  accum: str = "vpu_int32") -> None:
    """Publish one measured launch against the model: three counters per
    geometry BUCKET (launch count, measured seconds, predicted seconds) —
    the efficiency ratio is derived at snapshot time by
    ``repro_torch.obs.kernel_efficiency``.  The prediction uses the exact
    geometry and the launch's route, and counts what the wrapper knows: one
    AND per target and row-word (it reads neither the hit count nor the
    targets' sizes back) and, for ``mxu_f32``, ``C`` live planes in every
    row-word; only the
    aggregation label is bucketized (bounded label set)."""
    from ..obs import REGISTRY

    geom = _bucket_label(n, k, w, c)
    REGISTRY.counter("kernel_launches_total", geometry=geom).inc()
    REGISTRY.counter("kernel_measured_s_total", geometry=geom).inc(seconds)
    REGISTRY.counter("kernel_predicted_s_total", geometry=geom).inc(
        predicted_seconds(n, k, w, c, accum=accum))
