"""Plain PyTorch version of the Minority-Report encode kernels
(``csrc/mra_encode.cu``), on any device, word for word the kernels' output.

Bit words are int32 tensors holding the uint32 bits.  Rows are ``n``
(``offsets.numel() - 1``, and ``rare.numel()``); row ``r``'s walked item ids
are ``ids[offsets[r] : offsets[r + 1]]``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _low_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> their bits as int32 (little-endian)."""
    return x.contiguous().view(torch.int32)[..., 0::2].contiguous()


def _rows(offsets: torch.Tensor) -> torch.Tensor:
    """Each occurrence's row (int64)."""
    n = offsets.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   offsets.diff())


def count_rows_ref(ids: torch.Tensor, offsets: torch.Tensor,
                   rare: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Sorts each row's ids in ``ids`` in place -> (3, n_ids) int32: per
    item the rows holding it, the rare-class rows holding it, and ``n``
    minus the first rare-class row holding it (0 where none does)."""
    n, dev = rare.numel(), ids.device
    rows = _rows(offsets)
    keys = torch.sort(rows * max(n_ids, 1) + ids.long()).values
    ids.copy_(keys % max(n_ids, 1))
    pairs = torch.unique_consecutive(keys)
    i, r = pairs % max(n_ids, 1), pairs // max(n_ids, 1)
    in_rare = rare[r].bool()
    tag = torch.zeros(n_ids, dtype=torch.int64, device=dev).scatter_reduce_(
        0, i[in_rare], n - r[in_rare], "amax")
    counts = torch.stack([torch.bincount(i, minlength=n_ids),
                          torch.bincount(i[in_rare], minlength=n_ids), tag])
    return counts.to(torch.int32).view(3, n_ids)


def pack_rows_ref(ids: torch.Tensor, offsets: torch.Tensor,
                  cols: torch.Tensor, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (words (n, w) int32: bit ``c & 31`` of word ``c >> 5`` set where
    the row holds an id whose column ``cols[id]`` is ``c`` (-1: none);
    keys (ceil(w / 2), n) int64: key p orders words 2p, 2p + 1 as unsigned
    by its signed value)."""
    n, dev = offsets.numel() - 1, ids.device
    col = cols.long()[ids.long()]
    held = col >= 0
    r, c = _rows(offsets)[held], col[held]
    slots = torch.unique(r * (32 * w) + c)   # each (row, column) once
    r, c = slots // (32 * w), slots % (32 * w)
    words = torch.zeros(n * (w + 1), dtype=torch.int64, device=dev)
    words.index_add_(0, r * (w + 1) + (c >> 5), torch.ones_like(c) << (c & 31))
    words = words.view(n, w + 1)                       # a zero word last
    pairs = (w + 1) // 2
    keys = (words[:, 0:2 * pairs:2] - 2 ** 31) * 2 ** 32 \
        + words[:, 1:2 * pairs + 1:2]
    return _low_words(words[:, :w]), keys.T.contiguous()


def row_heads_ref(words: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """-> (n,) int32: 1 where row ``perm[i]`` differs from ``perm[i - 1]``
    (and at 0)."""
    rows = words[perm]
    head = torch.ones(perm.numel(), dtype=torch.int32, device=words.device)
    head[1:] = (rows[1:] != rows[:-1]).any(1).to(torch.int32)
    return head


def gather_rows_ref(words: torch.Tensor, perm: torch.Tensor,
                    run: torch.Tensor, head: torch.Tensor, rare: torch.Tensor,
                    runs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (bits (runs, w) int32: each run's row; weights (runs, 2) int32:
    its rows outside and inside the rare class), ``run`` numbering the
    sorted rows' runs from 1."""
    slot = 2 * (run.long() - 1) + rare[perm].long()
    weights = torch.zeros(2 * runs, dtype=torch.int64, device=words.device)
    weights.index_add_(0, slot, torch.ones_like(slot))
    return (words[perm[head.bool()]],
            weights.to(torch.int32).view(runs, 2))
