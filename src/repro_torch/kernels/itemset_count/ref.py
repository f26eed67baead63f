"""Plain PyTorch version of the multitude-targeted itemset-counting kernel.

Semantics (the GFP-growth counting step, dense form):

    counts[k, c] = sum_n weights[n, c] * [ tx_bits[n] contains tgt_bits[k] ]

where "contains" is bitwise: for every word w, (tx[n,w] & tgt[k,w]) == tgt[k,w].
This is a matmul over the (AND, ==, ALL) containment semiring followed by an
ordinary weighted reduction — exactly C(α) per target per class (paper Thm 1 /
§4.1 two-class counters), computed for a *multitude* of targets in one pass.

Runs on any device.  The bitmaps are read through ``int32`` views of the same
bits (``&`` and ``==`` give the same answers, and CUDA covers every int32 op),
and the weighted reduction is a float64 product: CUDA has no integer matmul,
and float64 is exact for every partial sum below 2^53 (a block of at most
``block_n`` rows of int32 weights stays far below that).  The per-block sums
are added in int64 and wrapped to int32 at the end, as an int32 product
would wrap.
"""
from __future__ import annotations

import torch


def check_inputs(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                 weights: torch.Tensor, where: str = "itemset_counts_ref"
                 ) -> None:
    """The typed errors every counting entry point raises on bad operands."""
    if tx_bits.dtype != torch.uint32 or tgt_bits.dtype != torch.uint32:
        raise TypeError(
            f"{where}: bitmap dtypes must be uint32, got "
            f"tx={tx_bits.dtype} tgt={tgt_bits.dtype}")
    if tx_bits.ndim != 2 or tgt_bits.ndim != 2 or weights.ndim != 2:
        raise ValueError(
            f"{where}: expected 2-D (N,W)/(K,W)/(N,C) inputs, "
            f"got ndim tx={tx_bits.ndim} tgt={tgt_bits.ndim} "
            f"w={weights.ndim}")
    if tx_bits.shape[1] != tgt_bits.shape[1]:
        raise ValueError(
            f"{where}: word-width mismatch: tx W="
            f"{tx_bits.shape[1]} vs tgt W={tgt_bits.shape[1]}")
    if tx_bits.shape[0] != weights.shape[0]:
        raise ValueError(
            f"{where}: row mismatch: tx N={tx_bits.shape[0]} "
            f"vs weights N={weights.shape[0]}")


def _counts_i64(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """(K, C) int64 counts of one block, containment tested word by word so
    the temporaries stay (K, N) whatever W is."""
    tx = tx_bits.view(torch.int32)
    tgt = tgt_bits.view(torch.int32)
    k, n = tgt.shape[0], tx.shape[0]
    contained = torch.ones((k, n), dtype=torch.bool, device=tx.device)
    for w in range(tx.shape[1]):
        t = tgt[:, w:w + 1]                              # (K, 1)
        contained &= (tx[:, w][None, :] & t) == t        # (K, N)
    prod = contained.to(torch.float64) @ weights.to(torch.float64)
    return prod.round().to(torch.int64)


def itemset_counts_ref(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """tx_bits (N, W) uint32; tgt_bits (K, W) uint32; weights (N, C) int32
    -> counts (K, C) int32, in one block."""
    check_inputs(tx_bits, tgt_bits, weights)
    return _counts_i64(tx_bits, tgt_bits, weights).to(torch.int32)


def itemset_counts_ref_blocked(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                               weights: torch.Tensor, block_n: int = 4096,
                               block_k: int = 2048) -> torch.Tensor:
    """Memory-bounded version for large N and K: blocks over both axes, so
    the (K_b, N_b) containment temporaries stay bounded."""
    check_inputs(tx_bits, tgt_bits, weights, "itemset_counts_ref_blocked")
    n, k = tx_bits.shape[0], tgt_bits.shape[0]
    out = torch.zeros((k, weights.shape[1]), dtype=torch.int64,
                      device=tx_bits.device)
    for k0 in range(0, k, block_k):
        tgt = tgt_bits[k0:k0 + block_k]
        for n0 in range(0, n, block_n):
            out[k0:k0 + block_k] += _counts_i64(
                tx_bits[n0:n0 + block_n], tgt, weights[n0:n0 + block_n])
    return out.to(torch.int32)
