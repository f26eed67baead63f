"""Roofline model of the ``itemset_count`` CUDA kernel, per launch geometry.

The counting kernel is a (N, W)-bitmap x (K, W)-target containment sweep
with a per-class weighted reduction: for every (row, target) pair it tests
whether the row holds the target's W packed words, then adds the row's C
weights for the contained pairs.  Per launch of geometry (N, K, W, C):

  bytes  = 4 * (N*W + N*C + K*W + K*C)      one pass over bitmap + weights,
                                            targets + the (K, C) result
  ops    = N*K * W + C * hits               per pair, one LOP3 per word:
                                            `miss |= t & ~row`, the last
                                            one also writing `miss == 0`
                                            to a predicate; C adds per
                                            contained pair

The per-pair count is what the built kernel issues: ``cuobjdump -sass`` of
``count_reg_kernel<2, 2>`` shows two ``LOP3.LUT`` per pair, the second with
a predicate output.  ``hits`` is the number of contained (row, target)
pairs, which depends on the data: a caller that knows it (``chip_smoke.py``
counts it on the card) passes it; the telemetry path does not, and its
prediction then counts the containment test alone, a floor of the work
that never flatters a launch.  (The JAX package's model charges
N*K*(2W + C), as if every pair paid W ANDs, W compares and all C adds;
at W = C = 2 that is three times the work.)

Predicted launch time is the perfect-overlap roofline bound
``max(bytes/HBM_BW, ops/PEAK_INT32_OPS)`` with the H100 SXM constants below.

``accum="mxu_f32"`` (K2, ``csrc/itemset_count_mxu.cu``) moves the weighted
reduction to the tensor cores as an int8 product over the weights' 4 byte
planes: the integer pipe keeps the containment test (N*K*W, no per-hit
adds), and the tensor cores do ``2*N*K*4C`` int8 operations.  Its bound is
the larger of the two times (and of the bytes): at the main-path level 3
(N = 969,130, K = 34,220, W = C = 2) about 3.97 ms of containment against
0.27 ms of tensor work, so K2's bound is essentially K1's.

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
from typing import Tuple

HBM_BW = 3.35e12                          # B/s
SM_COUNT = 132
INT32_LANES_PER_SM = 64
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_INT32_OPS = SM_COUNT * INT32_LANES_PER_SM * MAX_SM_CLOCK_HZ  # op/s
PEAK_INT8_TENSOR_OPS = 1.979e15           # op/s, dense int8 tensor cores

_WORD_BYTES = 4


def kernel_flops(n: int, k: int, w: int, c: int, hits: int = 0) -> float:
    """Integer-op count of one containment sweep: the W-word test of every
    (row, target) pair plus the C adds of each of ``hits`` contained
    pairs."""
    return float(n) * float(k) * float(w) + float(c) * float(hits)


def tensor_ops(n: int, k: int, c: int) -> float:
    """Int8 tensor-core operations of K2's reduction: a (K, N) x (N, 4C)
    product, two operations per multiply-add."""
    return 2.0 * float(n) * float(k) * 4.0 * float(c)


def kernel_bytes(n: int, k: int, w: int, c: int) -> float:
    """HBM traffic of one sweep: bitmap + weights + targets + result."""
    return _WORD_BYTES * (float(n) * w + float(n) * c
                          + float(k) * w + float(k) * c)


def _times(n: int, k: int, w: int, c: int, hits: int, accum: str):
    """(integer-pipe, tensor-core, memory) seconds of one launch."""
    if accum == "mxu_f32":
        return (kernel_flops(n, k, w, c) / PEAK_INT32_OPS,
                tensor_ops(n, k, c) / PEAK_INT8_TENSOR_OPS,
                kernel_bytes(n, k, w, c) / HBM_BW)
    return (kernel_flops(n, k, w, c, hits) / PEAK_INT32_OPS, 0.0,
            kernel_bytes(n, k, w, c) / HBM_BW)


def predicted_seconds(n: int, k: int, w: int, c: int, hits: int = 0,
                      accum: str = "vpu_int32") -> float:
    """Perfect-overlap roofline bound for one launch on the card.  ``hits``
    counts only for ``vpu_int32``: K2 adds no weights on the integer
    pipe."""
    return max(_times(n, k, w, c, hits, accum))


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
             accum: str = "vpu_int32") -> str:
    """Which side of the roofline bounds this geometry: ``"operations"`` or
    ``"bytes"``."""
    int_s, tensor_s, mem_s = _times(n, k, w, c, hits, accum)
    return "operations" if max(int_s, tensor_s) >= mem_s else "bytes"


def record_launch(n: int, k: int, w: int, c: int, seconds: float) -> None:
    """Publish one measured launch against the model: three counters per
    geometry BUCKET (launch count, measured seconds, predicted seconds) —
    the efficiency ratio is derived at snapshot time by
    ``repro_torch.obs.kernel_efficiency``.  The prediction uses the exact
    geometry and counts the containment test alone (the wrapper does not
    read the hit count back); only the aggregation label is bucketized
    (bounded label set)."""
    from ..obs import REGISTRY

    geom = _bucket_label(n, k, w, c)
    REGISTRY.counter("kernel_launches_total", geometry=geom).inc()
    REGISTRY.counter("kernel_measured_s_total", geometry=geom).inc(seconds)
    REGISTRY.counter("kernel_predicted_s_total", geometry=geom).inc(
        predicted_seconds(n, k, w, c))
