"""K2's b1 tensor-core instruction alone (``csrc/b1_probe.cu``): a one-tile
check against popc and the instruction's rate on the card.

Neither kernel library carries these; the kernel tests and ``chip_smoke.py``
build the probe to check the instruction K2 is built on and to measure the
rate ``roofline/kernel_model.py`` ties K2's bound to (a b1 ``m16n8k256``
issues at the rate of a u8 ``m16n8k32``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .ref import b1_tile_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "b1_probe.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the rate loop: iterations of 8 independent products per warp, CTAs of 8
# warps per SM, timed launches after two warm-up launches
RATE_ITERS = 4096
RATE_WAVES = 4
RATE_REPEATS = 5


def _fn(name: str, argtypes: list):
    from .._build import load

    fn = getattr(load(SOURCE), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def b1_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One b1 ``mma.sync.m16n8k256 ... and.popc``: ``a`` (16, 8) and ``b``
    (8, 8) uint32 words (row or column, k-word j holding k = 32j .. 32j +
    31) -> (16, 8) int32 ``sum_j popc(a[r, j] & b[n, j])``.  The plain
    version (``ref.b1_tile_ref``) on the CPU."""
    if a.device.type == "cpu":
        return b1_tile_ref(a, b)
    a = a.contiguous()
    b = b.contiguous()
    d = torch.empty((16, 8), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        err = _fn("b1_probe_tile", [_P] * 4)(
            a.data_ptr(), b.data_ptr(), d.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"b1 tile check failed to launch: cudaError {err}")
    return d


def mma_rate(b1: bool = True) -> float:
    """Operations per second of ``mma.sync`` on the current CUDA device: b1
    ``m16n8k256 and.popc`` (2*16*8*256 bit operations each), or u8
    ``m16n8k32`` (2*16*8*32 int8 operations each) with ``b1=False``.  Every
    warp of ``RATE_WAVES`` CTAs of 8 warps per SM issues ``RATE_ITERS`` x 8
    independent products; timed with CUDA events."""
    dev = torch.device("cuda", torch.cuda.current_device())
    blocks = (RATE_WAVES
              * torch.cuda.get_device_properties(dev).multi_processor_count)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    rate = _fn("b1_probe_rate", [_I] * 3 + [_P] * 2)
    stream = torch.cuda.current_stream(dev)

    def run():
        err = rate(int(b1), RATE_ITERS, blocks, sink.data_ptr(),
                   stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"mma rate loop failed to launch: cudaError "
                               f"{err}")

    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    for _ in range(RATE_REPEATS):
        run()
    end.record(stream)
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / RATE_REPEATS
    per = 2 * 16 * 8 * (256 if b1 else 32)
    return blocks * 8 * RATE_ITERS * 8 * per / seconds
