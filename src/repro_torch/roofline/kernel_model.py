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
"""
from __future__ import annotations

HBM_BW = 3.35e12                          # B/s
SM_COUNT = 132
INT32_LANES_PER_SM = 64
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_INT32_OPS = SM_COUNT * INT32_LANES_PER_SM * MAX_SM_CLOCK_HZ  # op/s

_WORD_BYTES = 4


def kernel_flops(n: int, k: int, w: int, c: int, hits: int = 0) -> float:
    """Integer-op count of one containment sweep: the W-word test of every
    (row, target) pair plus the C adds of each of ``hits`` contained
    pairs."""
    return float(n) * float(k) * float(w) + float(c) * float(hits)


def kernel_bytes(n: int, k: int, w: int, c: int) -> float:
    """HBM traffic of one sweep: bitmap + weights + targets + result."""
    return _WORD_BYTES * (float(n) * w + float(n) * c
                          + float(k) * w + float(k) * c)


def predicted_seconds(n: int, k: int, w: int, c: int, hits: int = 0,
                      peak_flops: float = PEAK_INT32_OPS,
                      hbm_bw: float = HBM_BW) -> float:
    """Perfect-overlap roofline bound for one launch on the card."""
    return max(kernel_flops(n, k, w, c, hits) / peak_flops,
               kernel_bytes(n, k, w, c) / hbm_bw)


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


def _bucket_label(n: int, k: int, w: int, c: int) -> str:
    """Bucket label with the hard cardinality cap applied."""
    b = geometry_bucket(n, k, w, c)
    if b in _SEEN_BUCKETS:
        return b
    if len(_SEEN_BUCKETS) >= MAX_GEOMETRY_BUCKETS:
        return GEOMETRY_OVERFLOW
    _SEEN_BUCKETS.add(b)
    return b


def bound_by(n: int, k: int, w: int, c: int, hits: int = 0) -> str:
    """Which side of the roofline bounds this geometry: ``"operations"`` or
    ``"bytes"``."""
    return ("operations" if kernel_flops(n, k, w, c, hits) / PEAK_INT32_OPS
            >= kernel_bytes(n, k, w, c) / HBM_BW else "bytes")


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
