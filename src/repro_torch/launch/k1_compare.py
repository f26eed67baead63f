"""Time K1 or K2 sources side by side on one CUDA card, at the
Minority-Report main path's three launches.

  PYTHONPATH=src python -m repro_torch.launch.k1_compare \\
      [--accum vpu_int32|mxu_f32] [--source NAME=FILE.cu ...] [--runs 7] \\
      [--block-k 128] [--block-n 512] [--out FILE.json]

Builds the shipped kernel of ``--accum`` (named "new": ``csrc/
itemset_count.cu`` for K1, ``vpu_int32``, the default; ``csrc/
itemset_count_mxu.cu`` for K2, ``mxu_f32``) and every ``--source`` (one
``nvcc`` each, in parallel).  A K1 source that exports
``itemset_count_geometry``, or a K2 source that exports
``itemset_count_mxu_layout``, has the shipped C interface: bit-sliced, with
a scratch large enough for any stage geometry of the route.  Any other
source has the row-by-row interface ``itemset_count_launch`` (K2:
``itemset_count_mxu_launch``) ``(tx, tgt, wts, out, n, k, w, c, threads,
tile_rows, accumulate, stream)``, as K1 and K2 had before they were
bit-sliced (earlier revisions of the sources from the history).

On the DB that ``chip_smoke.py`` mines (``bernoulli_db(1_000_000, 60, 0.125,
0.01, seed=0)`` through ``mra_encode``: N = 969,130, W = C = 2) it checks
every source against the plain version at level 2 (K = 1,770), level 3
(K = 34,220) and the fused pass (K = 1,830), then times them in turns (every
source, then every source in reverse order), called straight through ctypes
with ``--block-k`` and ``--block-n`` (the wrapper's defaults unless given):
``ms`` is the time per call of ``--runs`` calls back to back between two
CUDA events, the mean of the two turns.  Beside them: the shipped kernel
through its wrapper (``ops.itemset_counts``), its layout pass alone, and
the 8-chunk streamed sweep (131,072-row chunks resident on the card,
accumulating) of every source and of the wrapper, with the wrapper's host
enqueue time per chunk.  Prints one JSON line per launch and writes the
record to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

CHUNK_ROWS = 131072
LAUNCHES = (("level 2", (2,)), ("level 3", (3,)), ("fused", (1, 2)))


def _batch_ms(fn, runs: int, warmup: int = 2) -> float:
    """Time per call of ``runs`` calls back to back between two CUDA events:
    the device time per call wherever the host enqueues faster than the
    device runs."""
    import torch

    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accum", default="vpu_int32",
                    choices=("vpu_int32", "mxu_f32"),
                    help="the route: K1 (vpu_int32) or K2 (mxu_f32)")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=FILE.cu", help="another source of the route")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--block-k", type=int, default=None)
    ap.add_argument("--block-n", type=int, default=None)
    ap.add_argument("--out", type=Path, default=Path("build/k1_compare.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 1
    from .. import obs
    from ..data import bernoulli_db
    from ..kernels import _build
    from ..kernels.itemset_count import ops
    from ..mining.dense import mra_encode
    from ..mining.encode import encode_targets
    from ..roofline import autotune

    autotune.set_active_table(None)
    obs.configure(kernel_timing=False)    # the events below time the launches
    dev = torch.device("cuda")
    accum = args.accum
    bk = ops.DEFAULT_BLOCK_K if args.block_k is None else args.block_k
    bn = ops.DEFAULT_BLOCK_N if args.block_n is None else args.block_n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    shipped, entry, layout_name, _ = ops._ROUTES[accum]
    sources = {"new": shipped}
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).resolve()
    _build.build_all(list(sources.values()) + [ops.SOURCE, ops.SOURCE_MXU])
    ops.build()
    libs = {name: ctypes.CDLL(str(_build.library_path(src)))
            for name, src in sources.items()}
    _P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns, scratch = {}, {}
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        sliced = hasattr(lib, "itemset_count_geometry" if accum == "vpu_int32"
                         else layout_name)
        fn.argtypes = (ops._LAUNCH_ARGS if sliced
                       else [_P] * 4 + [_LL] * 2 + [_I] * 5 + [_P])
        fn.restype = _I
        fns[name] = (fn, sliced)

    def run(name, tx, tgt, w, out, accumulate=0):
        fn, sliced = fns[name]
        n, nw = tx.shape
        k, c = tgt.shape[0], w.shape[1]
        ptrs = [tx.data_ptr(), tgt.data_ptr(), w.data_ptr(), out.data_ptr()]
        if sliced:
            buf = scratch.get((name, n))
            if buf is None:
                # twice the shipped layout's scratch and room for the live
                # masks of stages of one row-word: a source with another
                # stage geometry fits too
                words = (2 * ops.sliced_geometry(n, nw, c, bn, accum).words
                         + c * (-(-n // 32) + 1))
                buf = torch.empty(words, dtype=torch.int32, device=dev)
                scratch[(name, n)] = buf
            ptrs += [buf.data_ptr(), buf.numel()]
        err = fn(*ptrs, n, k, nw, c, bk, bn, accumulate,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} kernel: cudaError {err}")
        return out

    tx_rows, y = bernoulli_db(1_000_000, 60, 0.125, 0.01, 0)
    db, items_kept, _ = mra_encode(tx_rows, y, min_support=1e-4,
                                   streaming=False, device=dev)
    tx_d, w_d = db.bits, db.weights
    u, nw = tx_d.shape
    layout = ops._layout_pass(accum)
    g = ops.sliced_geometry(u, nw, 2, bn, accum)
    layout_buf = torch.empty(g.words, dtype=torch.int32, device=dev)

    def prep():
        err = layout(tx_d.data_ptr(), w_d.data_ptr(), layout_buf.data_ptr(),
                     g.words, u, nw, 2, bn,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"layout pass: cudaError {err}")

    chunks = [(s, min(s + CHUNK_ROWS, u)) for s in range(0, u, CHUNK_ROWS)]
    names = list(fns)
    record = {"card": card, "torch": torch.__version__, "accum": accum,
              "cuda": torch.version.cuda, "n": u, "w": nw, "c": 2,
              "block_k": bk, "block_n": bn, "runs": args.runs,
              "sources": {k: str(v) for k, v in sources.items()},
              "launches": []}
    for label, sizes in LAUNCHES:
        tgt = torch.from_numpy(encode_targets(
            [cs for s in sizes for cs in itertools.combinations(items_kept, s)],
            db.vocab)).to(dev)
        k = tgt.shape[0]
        out = torch.empty((k, 2), dtype=torch.int32, device=dev)
        acc = torch.empty((k, 2), dtype=torch.int32, device=dev)
        want = ops.itemset_counts(tx_d, tgt, w_d, use_kernel=False)
        knobs = dict(block_k=bk, block_n=bn, accum=accum)

        def sweep(name):
            acc.zero_()
            for s, e in chunks:
                if name is None:
                    ops.itemset_counts_into(acc, tx_d[s:e], tgt, w_d[s:e],
                                            **knobs)
                else:
                    run(name, tx_d[s:e], tgt, w_d[s:e], acc, accumulate=1)

        for name in names + [None]:
            sweep(name)
            if not (torch.equal(run(name, tx_d, tgt, w_d, out) if name
                                else ops.itemset_counts(tx_d, tgt, w_d,
                                                        **knobs), want)
                    and torch.equal(acc, want)):
                raise AssertionError(f"{label}: {name or 'wrapper'} != plain")
        ms = {name: [] for name in names}
        sweep_ms = {name: [] for name in names}
        for name in names + names[::-1]:
            ms[name].append(_batch_ms(
                lambda: run(name, tx_d, tgt, w_d, out), args.runs))
            sweep_ms[name].append(_batch_ms(lambda: sweep(name), args.runs))
        # the wrapper's host time to enqueue a chunk, from an idle device
        enqueue = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for s, e in chunks:
                ops.itemset_counts_into(acc, tx_d[s:e], tgt, w_d[s:e],
                                        **knobs)
            enqueue.append((time.perf_counter() - t) * 1e3 / len(chunks))
        torch.cuda.synchronize()
        row = {"geometry": label, "k": k,
               "wrapper_ms": _batch_ms(
                   lambda: ops.itemset_counts(tx_d, tgt, w_d, **knobs),
                   args.runs),
               "prep_ms": _batch_ms(prep, args.runs),
               "sweep_chunks": len(chunks),
               "sweep_wrapper_ms": _batch_ms(lambda: sweep(None), args.runs),
               "sweep_enqueue_ms_per_chunk": statistics.median(enqueue)}
        for name in names:
            row[f"{name}_ms"] = statistics.mean(ms[name])
            row[f"{name}_ms_turns"] = ms[name]
            row[f"sweep_{name}_ms"] = statistics.mean(sweep_ms[name])
        record["launches"].append(row)
        print(json.dumps(row), flush=True)
    for name in names:
        record[f"sum_{name}_ms"] = sum(r[f"{name}_ms"]
                                       for r in record["launches"])
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items() if k != "launches"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
