"""The least time of a counting pass on one H100: a frozen copy of the
bytes and AND arithmetic of the port's ``roofline/kernel_model.py``
(``kernel_bytes``, ``and_ops``), kept here so that no later change to the
program moves the yardstick.

The count of target k over N rows of W 32-bit words and C class weights
moves ``4 * (N*W + N*C + K*W + K*C)`` bytes (each input read once, the (K, C)
result written once) and needs ``ceil(N / 32) * floor(s_k / 2)`` three-input
ANDs for a target of s_k items (the bit-sliced containment test, 32 rows a
word).  The least time is the larger of the bytes at the HBM rate and the
ANDs at the INT32 rate.  N, K and the sizes come from the work the inputs
need (``bench/reference/mra.py``'s ``Pass``), never from the shapes a kernel
was launched with, so every kernel route is held to the same work.

Constants: NVIDIA's H100 SXM data sheet, at the full 700 W power limit.

  * ``HBM_BW`` = 3.35e12 B/s, the HBM3 rate.
  * ``PEAK_INT32_OPS`` = 132 SMs x 64 INT32 lanes x 1.98e9 Hz (the card's
    maximum SM clock) = 1.67e13 op/s: LOP3 issues only to the INT32 lanes.
"""
from __future__ import annotations

from typing import Iterable

HBM_BW = 3.35e12
SM_COUNT = 132
INT32_LANES_PER_SM = 64
MAX_SM_CLOCK_HZ = 1.98e9
PEAK_INT32_OPS = SM_COUNT * INT32_LANES_PER_SM * MAX_SM_CLOCK_HZ


def and_ops(n: int, target_sizes: Iterable[int]) -> float:
    return float(-(-int(n) // 32)) * float(sum(int(s) // 2
                                               for s in target_sizes))


def kernel_bytes(n: int, k: int, w: int, c: int) -> float:
    return 4.0 * (float(n) * w + float(n) * c + float(k) * w + float(k) * c)


def least_seconds(passes) -> float:
    """Sum over the passes of each one's roofline bound."""
    return sum(max(kernel_bytes(p.rows, p.k, p.w, p.c) / HBM_BW,
                   and_ops(p.rows, p.target_sizes) / PEAK_INT32_OPS)
               for p in passes)
