"""Wrapper around the Minority-Report encode kernels (``csrc/mra_encode.cu``):
the stages of the MRA's encode after the host's walk, on the card.

A CUDA tensor launches the kernel (built by ``nvcc`` at first use) on the
current stream; any other device runs the plain PyTorch version in
``ref.py``, which gives the same words.  Shapes and meanings are
``ref.py``'s.  Launches are asynchronous: nothing here syncs.  The
wrappers check each buffer's type and length; the values are the caller's
to keep in range (ids below ``cols.numel()`` and the ``n_ids`` counted,
columns below ``32 * w``), as the walk and the kept items give them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .ref import count_rows_ref, gather_rows_ref, pack_rows_ref, row_heads_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mra_encode.cu"
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = {
    # ids, offsets, rare, n, n_ids, counts, stream
    "mra_count_rows": [_P, _P, _P, _LL, _I, _P, _P],
    # ids, offsets, n, cols, w, words, keys, stream
    "mra_pack_rows": [_P, _P, _LL, _P, _I, _P, _P, _P],
    # words, perm, n, w, head, stream
    "mra_row_heads": [_P, _P, _LL, _I, _P, _P],
    # words, perm, run, head, rare, n, w, bits, weights, stream
    "mra_gather_rows": [_P] * 5 + [_LL, _I] + [_P] * 3,
}
_FNS: dict = {}


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _FNS.get(name)
    if fn is None:
        from .._build import load

        fn = getattr(load(SOURCE), name)
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError {err}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int,
           device: torch.device) -> None:
    """The kernels read raw pointers: shapes and types are checked here."""
    if (t.dtype != dtype or t.numel() != numel or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor of "
                         f"{numel} elements on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_walk(ids: torch.Tensor, offsets: torch.Tensor) -> int:
    """-> the rows, ``ids`` and ``offsets`` checked against each other."""
    n = offsets.numel() - 1
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"{n} rows: needs 0 to 2^31 - 1")
    _check("ids", ids, torch.int32, ids.numel(), ids.device)
    _check("offsets", offsets, torch.int64, n + 1, ids.device)
    return n


def count_rows(ids: torch.Tensor, offsets: torch.Tensor, rare: torch.Tensor,
               n_ids: int) -> torch.Tensor:
    """Sorts each row's ids in place; -> the per-item counts."""
    n = _check_walk(ids, offsets)
    if not 0 <= n_ids < 2 ** 31:
        raise ValueError(f"count_rows: {n_ids} ids past int32")
    _check("rare", rare, torch.uint8, n, ids.device)
    if ids.device.type != "cuda":
        return count_rows_ref(ids, offsets, rare, n_ids)
    counts = torch.zeros(3, n_ids, dtype=torch.int32, device=ids.device)
    _launch("mra_count_rows", ids.device, ids.data_ptr(), offsets.data_ptr(),
            rare.data_ptr(), n, n_ids, counts.data_ptr())
    return counts


def pack_rows(ids: torch.Tensor, offsets: torch.Tensor, cols: torch.Tensor,
              w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = _check_walk(ids, offsets)
    _check("cols", cols, torch.int32, cols.numel(), ids.device)
    if not 0 < w < 2 ** 26:     # every column (below 32 * w) an int32
        raise ValueError(f"pack_rows: {w} words a row")
    if ids.device.type != "cuda":
        return pack_rows_ref(ids, offsets, cols, w)
    words = torch.empty(n, w, dtype=torch.int32, device=ids.device)
    keys = torch.empty((w + 1) // 2, n, dtype=torch.int64, device=ids.device)
    _launch("mra_pack_rows", ids.device, ids.data_ptr(), offsets.data_ptr(),
            n, cols.data_ptr(), w, words.data_ptr(), keys.data_ptr())
    return words, keys


def row_heads(words: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    n, w = words.shape
    _check("words", words, torch.int32, n * w, words.device)
    _check("perm", perm, torch.int64, n, words.device)
    if words.device.type != "cuda":
        return row_heads_ref(words, perm)
    head = torch.empty(perm.numel(), dtype=torch.int32, device=words.device)
    _launch("mra_row_heads", words.device, words.data_ptr(), perm.data_ptr(),
            perm.numel(), words.shape[1], head.data_ptr())
    return head


def gather_rows(words: torch.Tensor, perm: torch.Tensor, run: torch.Tensor,
                head: torch.Tensor, rare: torch.Tensor, runs: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, w = words.shape
    _check("words", words, torch.int32, n * w, words.device)
    for name, t, dtype in (("perm", perm, torch.int64),
                           ("run", run, torch.int32),
                           ("head", head, torch.int32),
                           ("rare", rare, torch.uint8)):
        _check(name, t, dtype, n, words.device)
    if words.device.type != "cuda":
        return gather_rows_ref(words, perm, run, head, rare, runs)
    bits = torch.empty(runs, w, dtype=torch.int32, device=words.device)
    weights = torch.zeros(runs, 2, dtype=torch.int32, device=words.device)
    _launch("mra_gather_rows", words.device, words.data_ptr(),
            perm.data_ptr(), run.data_ptr(), head.data_ptr(), rare.data_ptr(),
            perm.numel(), w, bits.data_ptr(), weights.data_ptr())
    return bits, weights
