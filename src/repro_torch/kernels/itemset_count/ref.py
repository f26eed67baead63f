"""Plain PyTorch version of the multitude-targeted itemset-counting kernel.

Semantics (the GFP-growth counting step, dense form):

    counts[k, c] = sum_n weights[n, c] * [ tx_bits[n] contains tgt_bits[k] ]

where "contains" is bitwise: for every word w, (tx[n,w] & tgt[k,w]) == tgt[k,w].
This is a matmul over the (AND, ==, ALL) containment semiring followed by an
ordinary weighted reduction — exactly C(α) per target per class (paper Thm 1 /
§4.1 two-class counters), computed for a *multitude* of targets in one pass.

Runs on any device.  The bitmaps are read through ``int32`` views of the same
bits (``&`` and ``==`` give the same answers, and CUDA covers every int32 op).
The weighted reduction follows the kernel's ``accum`` route:

  * ``"vpu_int32"`` (K1): a float64 product — CUDA has no integer matmul, and
    float64 is exact for every partial sum below 2^53 (a block of at most
    ``block_n`` rows of int32 weights stays far below that);
  * ``"mxu_f32"`` (K2): a float32 product, as the TPU's MXU reduces, exact
    while every partial sum stays below 2^24.  It runs with TF32 switched off
    (``_exact_f32``): TF32 keeps 10 mantissa bits and would round integer
    weights.

The per-block sums are added in int64 and wrapped to int32 at the end, as an
int32 product would wrap.

The bit-sliced form that both kernels count over (``csrc/bitslice.cuh``)
has its plain version here too, for the tests and ``chip_smoke.py``:
``to_item_columns`` and ``to_weight_planes`` (with ``heavy_rows`` for K1,
``whole_masks`` for K2) give the words of the kernels' layouts over
``ceil(N / 32)`` row-words (their layout passes, which pad to whole stages
with zero rows, are compared with them bit for bit), ``live_planes`` gives
the order in which K2 feeds the live planes to the tensor cores, and
``itemset_counts_sliced`` counts over them,
``sum_b popc(h & plane_b) << b`` over the live planes of each stage, where
``h`` is the AND of the target's item columns.  The stage is a parameter:
the kernels' own stage geometry lives in their sources alone.
"""
from __future__ import annotations

import contextlib

import torch

ACCUMS = ("vpu_int32", "mxu_f32")


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


def check_accum(accum: str) -> None:
    if accum not in ACCUMS:
        raise ValueError(f"unknown accum {accum!r}; expected one of {ACCUMS}")


@contextlib.contextmanager
def _exact_f32():
    """Full float32 matrix products (no TF32) inside the block; the caller's
    settings come back afterwards."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def _counts_i64(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                weights: torch.Tensor, accum: str = "vpu_int32"
                ) -> torch.Tensor:
    """(K, C) int64 counts of one block, containment tested word by word so
    the temporaries stay (K, N) whatever W is."""
    tx = tx_bits.view(torch.int32)
    tgt = tgt_bits.view(torch.int32)
    k, n = tgt.shape[0], tx.shape[0]
    contained = torch.ones((k, n), dtype=torch.bool, device=tx.device)
    for w in range(tx.shape[1]):
        t = tgt[:, w:w + 1]                              # (K, 1)
        contained &= (tx[:, w][None, :] & t) == t        # (K, N)
    if accum == "mxu_f32":
        with _exact_f32():
            prod = contained.to(torch.float32) @ weights.to(torch.float32)
    else:
        prod = contained.to(torch.float64) @ weights.to(torch.float64)
    return prod.round().to(torch.int64)


def itemset_counts_ref(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                       weights: torch.Tensor, accum: str = "vpu_int32"
                       ) -> torch.Tensor:
    """tx_bits (N, W) uint32; tgt_bits (K, W) uint32; weights (N, C) int32
    -> counts (K, C) int32, in one block, reduced by ``accum``'s route."""
    check_inputs(tx_bits, tgt_bits, weights)
    check_accum(accum)
    return _counts_i64(tx_bits, tgt_bits, weights, accum).to(torch.int32)


def itemset_counts_ref_blocked(tx_bits: torch.Tensor, tgt_bits: torch.Tensor,
                               weights: torch.Tensor, block_n: int = 4096,
                               block_k: int = 2048,
                               accum: str = "vpu_int32") -> torch.Tensor:
    """Memory-bounded version for large N and K: blocks over both axes, so
    the (K_b, N_b) containment temporaries stay bounded."""
    check_inputs(tx_bits, tgt_bits, weights, "itemset_counts_ref_blocked")
    check_accum(accum)
    n, k = tx_bits.shape[0], tgt_bits.shape[0]
    out = torch.zeros((k, weights.shape[1]), dtype=torch.int64,
                      device=tx_bits.device)
    for k0 in range(0, k, block_k):
        tgt = tgt_bits[k0:k0 + block_k]
        for n0 in range(0, n, block_n):
            out[k0:k0 + block_k] += _counts_i64(
                tx_bits[n0:n0 + block_n], tgt, weights[n0:n0 + block_n],
                accum)
    return out.to(torch.int32)


# -- the bit-sliced form (K1's layout) -----------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as uint32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(
        torch.uint32)


def _bits64(x: torch.Tensor) -> torch.Tensor:
    """uint32 or int32 tensor -> int64 values of its 32 bits."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & 0xFFFFFFFF


def _slice_rows(vals: torch.Tensor, block_words: int = 256) -> torch.Tensor:
    """(N, F) int64 32-bit values -> (F * 32, ceil(N / 32)) int64 column
    words: word j of column 32 * f + b holds bit b of field f of rows
    32 * j .. 32 * j + 31 (row 32 * j + l at bit l); rows past N are zero."""
    n, f = vals.shape
    nw = _cdiv(n, 32)
    out = torch.zeros((nw, f * 32), dtype=torch.int64, device=vals.device)
    shifts = torch.arange(32, device=vals.device)
    for j0 in range(0, nw, block_words):
        j1 = min(j0 + block_words, nw)
        blk = torch.zeros(((j1 - j0) * 32, f), dtype=torch.int64,
                          device=vals.device)
        part = vals[j0 * 32:j1 * 32]
        blk[:part.shape[0]] = part
        bits = (blk.view(j1 - j0, 32, f)[..., None] >> shifts) & 1
        # (words, 32 rows l, f, 32 bits b) -> sum over l of bit << l
        out[j0:j1] = (bits << shifts[None, :, None, None]).sum(1).reshape(
            j1 - j0, f * 32)
    return out.T


def to_item_columns(tx_bits: torch.Tensor) -> torch.Tensor:
    """(N, W) uint32 rows -> (32 * W + 1, ceil(N / 32)) uint32 item columns:
    column i holds item i (bit i % 32 of word i // 32) of 32 rows per word,
    then the all-ones column of the empty itemset."""
    cols = _slice_rows(_bits64(tx_bits))
    ones = torch.full((1, cols.shape[1]), 0xFFFFFFFF, dtype=torch.int64,
                      device=cols.device)
    return _u32(torch.cat([cols, ones]))


def to_weight_planes(weights: torch.Tensor, stage_words: int):
    """(N, C) int32 weights -> ``(planes, live)``: ``planes`` (C, 32,
    ceil(N / 32)) uint32, plane b of class c holding bit b of the
    two's-complement weights of 32 rows per word; ``live`` (C, nst) uint32
    over stages of ``stage_words`` row-words (the last one may be short),
    bit b set iff plane b has a set bit in the stage (the OR of the stage's
    weights)."""
    n, c = weights.shape
    nw = _cdiv(n, 32)
    nst = _cdiv(nw, stage_words)
    planes = _slice_rows(_bits64(weights.to(torch.int32))).view(c, 32, nw)
    padded = torch.zeros((c, 32, nst * stage_words), dtype=torch.int64,
                         device=planes.device)
    padded[..., :nw] = planes
    nonzero = (padded.view(c, 32, nst, stage_words) != 0).any(-1)  # (C,32,nst)
    shifts = torch.arange(32, device=planes.device)[None, :, None]
    live = (nonzero.to(torch.int64) << shifts).sum(1)
    return _u32(planes), _u32(live)


def whole_masks(weights: torch.Tensor) -> torch.Tensor:
    """(N, C) int32 weights -> (C,) uint32 whole-launch masks: bit b of
    class c set iff plane b of class c has a set bit anywhere (the OR of
    the class's weights)."""
    w = _bits64(weights.to(torch.int32))
    out = torch.zeros(w.shape[1], dtype=torch.int64, device=w.device)
    for b in range(32):
        out |= ((w >> b) & 1).amax(0) << b if w.shape[0] else 0
    return _u32(out)


def live_plane_words(weights: torch.Tensor) -> int:
    """(N, C) int32 weights -> the live plane words: over every row-word of
    32 rows, the (class, bit) planes with a set bit there.  The b1 product
    of ``roofline/kernel_model.py`` counts 32 rows a target for each."""
    planes, _ = to_weight_planes(weights, 1)
    return int((planes != 0).sum())


def live_planes(whole: torch.Tensor) -> torch.Tensor:
    """(C,) uint32 whole-launch masks -> (P,) int64 codes ``32 * c + b`` of
    the live (class, bit) planes, bit-major (plane 0 of every class, then
    plane 1, ...): the order in which K2 packs them into n8 tiles of 8."""
    m = _bits64(whole)
    c = m.shape[0]
    bit = torch.arange(32, device=m.device)
    on = ((m[None, :] >> bit[:, None]) & 1).bool()              # (32, C)
    b_idx, c_idx = torch.nonzero(on, as_tuple=True)             # bit-major
    return 32 * c_idx + b_idx


def b1_tile_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One b1 AND + POPC product: ``a`` (16, 8) and ``b`` (8, 8) uint32
    words -> (16, 8) int32 ``d[r, n] = sum_j popc(a[r, j] & b[n, j])``."""
    x = _bits64(a)[:, None, :] & _bits64(b)[None, :, :]          # (16, 8, 8)
    return _popcount32(x).sum(-1).to(torch.int32)


def heavy_rows(planes: torch.Tensor) -> torch.Tensor:
    """(C, 32, words) weight planes -> (words,) uint32: the rows whose weight
    is neither 0 nor 1 in some class (a set bit in a plane b >= 1)."""
    pl = _bits64(planes)
    out = torch.zeros(pl.shape[2], dtype=torch.int64, device=pl.device)
    for c in range(pl.shape[0]):
        for b in range(1, 32):
            out |= pl[c, b]
    return _u32(out)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def itemset_counts_sliced(columns: torch.Tensor, planes: torch.Tensor,
                          live: torch.Tensor, tgt_bits: torch.Tensor,
                          stage_words: int, block_k: int = 256
                          ) -> torch.Tensor:
    """(K, C) int32 counts over the bit-sliced form: for each target, ``h``
    is the AND of its item columns (the all-ones column for the empty
    itemset), and each class adds ``popc(h & plane_b) << b`` over the planes
    that ``live`` marks in each stage of ``stage_words`` row-words,
    wrapping modulo 2^32."""
    cols = _bits64(columns)
    c, _, nwp = planes.shape
    lv = _bits64(live)                                          # (C, nst)
    bit = torch.arange(32, device=cols.device)
    keep = ((lv[:, None, :] >> bit[None, :, None]) & 1).repeat_interleave(
        stage_words, dim=2)[..., :nwp] * 0xFFFFFFFF             # (C, 32, nwp)
    pl = _bits64(planes) & keep
    k, w = tgt_bits.shape
    member = ((_bits64(tgt_bits)[:, :, None] >> bit) & 1).reshape(k, w * 32)
    out = torch.zeros((k, c), dtype=torch.int64, device=cols.device)
    for k0 in range(0, k, block_k):
        mk = member[k0:k0 + block_k].bool()
        h = cols[-1].expand(mk.shape[0], nwp).clone()
        for i in torch.nonzero(mk.any(0)).flatten().tolist():
            sel = mk[:, i]
            h[sel] &= cols[i]
        for ci in range(c):
            for b in range(32):
                out[k0:k0 + block_k, ci] += _popcount32(
                    h & pl[ci, b]).sum(1) << b
    return _u32(out & 0xFFFFFFFF).view(torch.int32)
