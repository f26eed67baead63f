#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card, phase by
phase, and fail on the first phase that fails.

  python3 chip_smoke.py

1. Header: the card, its power limit, torch/CUDA versions, the nvcc build.
2. The itemset-count CUDA kernel against its plain PyTorch version on the
   card (``torch.equal``): the kernel test shapes, W = 64/65, C up to 17,
   N = 1 and 2^20 + 3, empty inputs, accumulate mode, a sweep of the launch
   knobs (block_k, block_n), and the three main-path geometries on the DB
   that ``mining.dense.mra_encode`` builds from
   ``bernoulli_db(1_000_000, 60, 0.125, 0.01, seed=0)`` (N = 969,130 unique
   rows, W = 2, C = 2, K = 1,770 / 34,220 / 1,830); targets of at most 1,
   4 and 8 items and of more than 8, W too wide for a stage in shared memory, full-range weights.
   Then K1's layout pass (``ops.bit_slice``) against its plain version
   (``ref.to_item_columns``, ``ref.to_weight_planes``' odd planes and live
   masks, ``ref.heavy_rows``), bit for bit over the rows' words with the pad
   up to whole stages zero, on
   the same shapes and the main-path DB, so that a layout fault shows apart
   from a counting fault.
3. Timing at the main-path geometries: the kernel's time per call (CUDA
   events around 7 calls back to back, median of 3 such batches), the
   layout pass and the count kernel apart (``prep_ms`` and ``count_ms``,
   from a ``torch.profiler`` trace), the roofline bound of
   ``roofline/kernel_model.py`` with this data's hit count and target sizes
   (and the horizontal model's bound beside it), the plain version's
   median; fails if a kernel runs below its bound.
4. The streamed sweep at those geometries (8 chunks): its time with kernel
   timing on and off, a ``torch.profiler`` trace of it, read for how much
   of the host-to-device copy time the kernels hide, and its bound (K3):
   the sum of the 8 chunks' bounds with each chunk's hit count; fails if
   the sweep's kernels run below it.
5. The main path at full size: ``minority_report_dense`` on the same DB,
   dense, streamed in 8 chunks, and with the plain version; identical
   rules, and the kernel's launch counter read around each run.
6. ``repro_torch.launch.mine --verify`` at 200,000 rows against the host
   oracle.
7. The tensor-core kernel (K2, ``accum="mxu_f32"``) against its plain
   version (``torch.equal``): phase 2's shapes in plain and accumulate
   mode, full-range int32 weights against K1's plain version, launch knobs
   (``block_n`` sets K2's stage too), the near-2^24 case, and the three
   main-path geometries; then K2's layout pass (``ops.bit_slice(...,
   accum="mxu_f32")``) against ``ref.to_item_columns`` /
   ``ref.to_weight_planes`` / ``ref.whole_masks`` bit for bit, pad words
   zero.
8. The b1 product alone (``b1_probe.b1_tile`` against ``ref.b1_tile_ref``
   on random tiles) and its rate on the card (``b1_probe.mma_rate``, b1
   and u8, printed beside the model's constant); the main-path DB's live
   weight planes P and live plane words; then K2's timing at the main-path
   geometries beside K1's from phase 3, its layout pass and count kernel
   apart (``torch.profiler``), its bound (``kernel_model.py`` with
   ``accum="mxu_f32"`` and the live plane words) with the first K2's
   byte-plane bound beside it, and its plain version's time.
9. The autotune sweep on the card: ``repro_torch.launch.autotune --preset
   main`` into ``build/autotune/``, every candidate's time, the table's
   round trip through the loader and the derived chooser thresholds.
10. The tuned main path at 1,000,000 rows: ``minority_report_dense`` under
    the swept table, then dense and streamed under a table pinned to
    ``mxu_f32`` at every bucket the mine touches; the same rules as phase 5,
    and the per-route launch counters read around each run.
11. The chooser and the GFP hybrid: ``backend_for_db``'s verdict and traits
    on the 1M-row DB, ``gfp_mine_frequent`` equal to the dense backend's
    frequent set, and the launcher's ``--backend auto --verify`` and
    ``--backend gfp --verify`` at 200,000 rows against the host oracle.

The last lines are the card's name and power limit, the kernels' JSON
record (K1, K2 and K3, the accumulate-into launch) and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import contextlib
import io
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import astuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN = dict(n=1_000_000, items=60, p_x=0.125, p_y=0.01, seed=0,
            min_support=1e-4, min_conf=0.01)
STREAM_CHUNK_ROWS = 131072
KERNEL_RUNS = 7
PLAIN_RUNS = 3


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(t0):
    print(f"   phase seconds: {time.perf_counter() - t0:.3f}", flush=True)


def _random_problem(rng, n, k, w, c, density=0.3):
    """The tests' random counting problem: sparse rows, 1-3 bit targets."""
    import numpy as np
    tx = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    tx &= rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    tgt = np.zeros((k, w), dtype=np.uint32)
    for i in range(k):
        for _ in range(rng.integers(1, 4)):
            b = rng.integers(0, 32 * w)
            tgt[i, b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    wts = rng.integers(0, 7, size=(n, c)).astype(np.int32)
    return tx, tgt, wts


def _target_sizes(tgt):
    """Items per target of a (K, W) uint32 tensor."""
    import numpy as np
    return np.unpackbits(tgt.cpu().numpy().view(np.uint8), axis=1).sum(1)


def _device_intervals(trace_path):
    """(kernel, host-to-device copy) intervals in microseconds from a
    ``torch.profiler`` Chrome trace."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    kern, h2d = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "kernel":
            kern.append(span)
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            h2d.append(span)
    return kern, h2d


def _profiled_ms(fn, runs, trace_path, names):
    """Device time per launch of the kernels whose names contain each of
    ``names`` (each call launches each once), from a ``torch.profiler``
    trace of ``runs`` calls: the mean over the launches the trace recorded
    (the tracer may drop some); None for a name the trace has no event
    of."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    out = {}
    for key in names:
        durs = [float(e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") == "kernel"
                and key in e.get("name", "")]
        out[key] = sum(durs) / 1e3 / len(durs) if durs else None
    return out


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(spans):
    return sum(e - s for s, e in spans)


def _intersect(a, b):
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _batch_ms(fn, runs, batches=3):
    """Median over ``batches`` of the time per call of ``runs`` calls back to
    back between two CUDA events: the device time per call wherever the
    host enqueues faster than the device runs."""
    import torch
    fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return statistics.median(times)


def _time_ms(fn, runs, warmup):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.kernels.itemset_count import b1_probe, ops
    from repro_torch.kernels.itemset_count.ops import (itemset_counts,
                                                       itemset_counts_into)
    from repro_torch.kernels.itemset_count.ref import (b1_tile_ref,
                                                       heavy_rows,
                                                       live_plane_words,
                                                       live_planes,
                                                       to_item_columns,
                                                       to_weight_planes,
                                                       whole_masks)
    from repro_torch.roofline import autotune, kernel_model

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. header ---------------------------------------------------------
    t0 = _phase("1. header")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   card: {smi}; max/current SM clock: {clocks}")
    print(f"   python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    tb = time.perf_counter()
    sources = (ops.SOURCE, ops.SOURCE_MXU, b1_probe.SOURCE)
    _build.build_all(sources)
    ops.build()
    for src in sources:
        log = _build.BUILD_LOGS.get(src.stem, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"   nvcc build of {src.name}: "
              f"{_build.BUILD_SECONDS.get(src.stem, 0.0):.3f} s -> "
              f"{_build.library_path(src).relative_to(ROOT)}; ptxas: "
              f"{len(regs)} kernels, {min(regs, default=0)}-"
              f"{max(regs, default=0)} registers, {spills} spill bytes")
    print(f"   all {len(sources)} built in parallel and loaded in "
          f"{time.perf_counter() - tb:.3f} s")
    autotune.set_active_table(None)      # untuned until phase 9
    _done(t0)

    # ---- 2. kernel against its plain version --------------------------------
    t0 = _phase("2. kernel == plain version on the card")
    max_err = 0
    n_checked = 0

    def check(tx, tgt, wts, label, acc0=None):
        nonlocal max_err, n_checked
        want = itemset_counts(tx, tgt, wts, use_kernel=False)
        if acc0 is None:
            got = itemset_counts(tx, tgt, wts)
        else:
            got = itemset_counts_into(acc0.clone(), tx, tgt, wts)
            want = acc0 + want
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        n_checked += 1
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at {label} "
                                 f"(max abs err {err})")

    shapes = [(1, 1, 1, 1), (128, 8, 1, 1), (200, 5, 2, 2), (1024, 256, 4, 2),
              (1500, 300, 4, 3), (4096, 64, 8, 1), (333, 17, 16, 4),
              (777, 130, 33, 2), (2000, 50, 64, 2), (2000, 50, 65, 2),
              (1, 40, 2, 2), ((1 << 20) + 3, 64, 2, 2),
              ((1 << 20) + 3, 33, 3, 17)]
    shapes += [(5000, 100, 2, c) for c in (1, 2, 3, 8, 17)]
    rng = np.random.default_rng(0)
    for n, k, w, c in shapes:
        arrs = [torch.from_numpy(a).to(dev)
                for a in _random_problem(rng, n, k, w, c)]
        check(*arrs, f"N={n} K={k} W={w} C={c}")
        acc0 = torch.from_numpy(
            rng.integers(-1000, 1000, size=(k, c)).astype(np.int32)).to(dev)
        check(*arrs, f"accumulate N={n} K={k} W={w} C={c}", acc0=acc0)
    for n, k in ((0, 3), (5, 0)):
        tx = torch.zeros((n, 2), dtype=torch.uint32, device=dev)
        tgt = torch.zeros((k, 2), dtype=torch.uint32, device=dev)
        out = itemset_counts(tx, tgt, torch.ones((n, 2), dtype=torch.int32,
                                                 device=dev))
        if tuple(out.shape) != (k, 2) or out.any():
            raise AssertionError(f"empty case N={n} K={k}: {out}")
    print(f"   {n_checked} random comparisons over {len(shapes)} shapes "
          f"(plain and accumulate) and 2 empty cases: equal")
    n_knobs = 0
    for n, k, w, c in ((5000, 300, 2, 2), (4000, 70, 3, 1), (3000, 90, 4, 2),
                       (2000, 50, 65, 2), (3000, 40, 2, 5)):
        tx, tgt, wts = [torch.from_numpy(a).to(dev)
                        for a in _random_problem(rng, n, k, w, c)]
        want = itemset_counts(tx, tgt, wts, use_kernel=False)
        for bk, bn in itertools.product((1, 32, 96, 1024), (1, 100, 4096)):
            got = itemset_counts(tx, tgt, wts, block_k=bk, block_n=bn)
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain version at N={n} K={k} "
                                     f"W={w} C={c} block_k={bk} block_n={bn}")
            n_knobs += 1
    print(f"   launch knobs: {n_knobs} (block_k, block_n) settings over 5 "
          f"shapes: equal")
    # K1's other loops: wide targets (the general loop), the empty itemset, W
    # too wide for a stage in shared memory (columns read from device
    # memory), C in class groups; full-range int32 weights
    n_wide = 0
    for n, k, w, c in ((5000, 60, 3, 2), (3001, 50, 2, 5), (999, 40, 300, 2),
                       (4000, 50, 65, 17)):
        tx, tgt, _ = _random_problem(rng, n, k, w, c)
        tgt[2:k // 2] = tx[:k // 2 - 2] & rng.integers(
            0, 2 ** 32, size=(k // 2 - 2, w), dtype=np.uint32)
        tgt[0] = 0
        wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                           dtype=np.int64).astype(np.int32)
        arrs = [torch.from_numpy(a).to(dev) for a in (tx, tgt, wts)]
        for bk, bn in ((128, 512), (1, 1), (1024, 4096)):
            got = itemset_counts(*arrs, block_k=bk, block_n=bn)
            want = itemset_counts(*arrs, use_kernel=False)
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain version at wide "
                                     f"targets N={n} K={k} W={w} C={c} "
                                     f"block_k={bk} block_n={bn}")
            n_wide += 1
        check(*arrs, f"accumulate wide targets N={n} W={w} C={c}",
              acc0=torch.randint(-9, 9, (k, c), dtype=torch.int32,
                                 device=dev))
    print(f"   {n_wide} settings with targets of more than 8 items, the "
          f"empty itemset, W = 300 and full-range weights: equal")
    # CTAs whose largest target has 1 item (the 2-column loop), 4 or 8 items
    # (the general loop): targets of 0 .. smax items
    tx, _, wts = _random_problem(rng, 3000, 1, 2, 2)
    tx |= rng.integers(0, 2 ** 32, size=tx.shape, dtype=np.uint32)
    n_sizes = 0
    for smax in (1, 4, 8):
        tgt = np.zeros((200, 2), dtype=np.uint32)
        for i in range(200):
            for b in rng.choice(64, size=rng.integers(0, smax + 1),
                                replace=False):
                tgt[i, b >> 5] |= np.uint32(1) << np.uint32(b & 31)
        arrs = [torch.from_numpy(a).to(dev) for a in (tx, tgt, wts)]
        want = itemset_counts(*arrs, use_kernel=False)
        for bk in (32, 128):
            if not torch.equal(itemset_counts(*arrs, block_k=bk), want):
                raise AssertionError(f"kernel != plain version at targets "
                                     f"of at most {smax} items, "
                                     f"block_k={bk}")
            n_sizes += 1
    print(f"   {n_sizes} settings with targets of at most 1, 4 and 8 items: "
          f"equal")

    from repro_torch.data import bernoulli_db
    from repro_torch.mining.dense import mra_encode
    from repro_torch.mining.encode import encode_targets

    tg = time.perf_counter()
    tx_rows, y = bernoulli_db(MAIN["n"], MAIN["items"], MAIN["p_x"],
                              MAIN["p_y"], MAIN["seed"])
    t_gen = time.perf_counter() - tg
    te = time.perf_counter()
    db, items_kept, _ = mra_encode(tx_rows, y, min_support=MAIN["min_support"],
                                   streaming=False, device=dev)
    t_enc = time.perf_counter() - te
    tx_d, w_d = db.bits, db.weights
    u, w_words = tx_d.shape
    geoms = [(label, encode_targets(
        [cs for s in sizes for cs in itertools.combinations(items_kept, s)],
        db.vocab)) for label, sizes in (("level 2", (2,)), ("level 3", (3,)),
                                        ("fused two-class pass", (1, 2)))]
    print(f"   main-path DB (mra_encode): {len(tx_rows)} rows generated in "
          f"{t_gen:.3f} s, encoded in {t_enc:.3f} s: U={u} unique rows, "
          f"W={w_words}, C=2, {len(items_kept)} items")
    tgts = []
    for label, m in geoms:
        tgt_d = torch.from_numpy(m).to(dev)
        tgts.append((label, tgt_d))
        check(tx_d, tgt_d, w_d, f"{label} K={m.shape[0]}")
        acc0 = torch.from_numpy(
            rng.integers(-1000, 1000, size=(m.shape[0], 2)).astype(
                np.int32)).to(dev)
        check(tx_d, tgt_d, w_d, f"accumulate {label}", acc0=acc0)
        print(f"   {label}: K={m.shape[0]} equal (plain and accumulate)")
    print(f"   K1 == plain version: {n_checked} comparisons, max abs err "
          f"{max_err}")

    # K1's layout pass against its plain version, bit for bit
    n_layouts = 0
    for n, _, w, c in shapes + [(999, 0, 300, 2), (u, 0, w_words, 2)]:
        if n == u:
            tx, wts = tx_d, w_d
        else:
            tx, _, _ = _random_problem(rng, n, 1, w, c)
            wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                               dtype=np.int64).astype(np.int32)
            tx, wts = (torch.from_numpy(a).to(dev) for a in (tx, wts))
        for bn in (512, 100) if n != u else (512,):
            got = ops.bit_slice(tx, wts, block_n=bn)
            planes, live = to_weight_planes(wts, got.stage_words)
            want = (to_item_columns(tx), planes[:, 0], heavy_rows(planes),
                    live)
            words = -(-n // 32)
            for name, g, x in zip(("columns", "odd planes", "heavy", "live"),
                                  got, want):
                g = g.view(torch.int32)
                # the rows' words bit for bit; the pad up to whole stages
                # zero (all ones in the all-ones column)
                pad = g[..., words:] if name != "live" else g[..., :0]
                if name == "columns":
                    pad = torch.cat([pad[:-1].flatten(), ~pad[-1]])
                if (not torch.equal(g[..., :x.shape[-1]], x.view(torch.int32))
                        or pad.any()):
                    raise AssertionError(f"layout pass != plain version: "
                                         f"{name} at N={n} W={w} C={c} "
                                         f"block_n={bn}")
            n_layouts += 1
    print(f"   layout pass == to_item_columns / to_weight_planes bit for "
          f"bit: {n_layouts} layouts (the main-path DB included)")
    _done(t0)

    # ---- 3. timing -----------------------------------------------------------
    t0 = _phase("3. timing at the main-path geometries")
    obs.configure(kernel_timing=False)   # the events below time the launches
    ones = torch.ones((u, 1), dtype=torch.int32, device=dev)
    (ROOT / "build" / "traces").mkdir(parents=True, exist_ok=True)
    per_launch = []
    for label, tgt_d in tgts:
        k = tgt_d.shape[0]
        # contained (row, target) pairs and the targets' sizes: the
        # data-dependent part of the work
        hits = int(itemset_counts(tx_d, tgt_d, ones, use_kernel=False).sum())
        sizes = _target_sizes(tgt_d)
        ms = _batch_ms(lambda: itemset_counts(tx_d, tgt_d, w_d), KERNEL_RUNS)
        # the layout pass and the count kernel apart, from a profiler trace
        # (the layout pass alone through its wrapper is host-bound)
        parts = _profiled_ms(lambda: itemset_counts(tx_d, tgt_d, w_d),
                             KERNEL_RUNS, ROOT / "build" / "traces" /
                             f"k1_{label.split()[0]}.json",
                             ("layout_kernel", "count_kernel"))
        prep_ms = parts["layout_kernel"]
        if prep_ms is None:
            prep_ms = _batch_ms(lambda: ops.bit_slice(tx_d, w_d),
                                KERNEL_RUNS)
            print(f"   {label}: the profiler recorded no layout kernel; "
                  f"prep_ms is the layout pass's wrapper time")
        plain_ms = _time_ms(
            lambda: itemset_counts(tx_d, tgt_d, w_d, use_kernel=False),
            PLAIN_RUNS, 1)
        bound_ms = kernel_model.predicted_seconds(
            u, k, w_words, 2, hits=hits, target_sizes=sizes) * 1e3
        by = kernel_model.bound_by(u, k, w_words, 2, hits=hits,
                                   target_sizes=sizes)
        hbound_ms = kernel_model.horizontal_seconds(u, k, w_words, 2,
                                                    hits=hits) * 1e3
        per_launch.append(dict(geometry=label, n=u, k=k, w=w_words, c=2,
                               hits=hits, ms=ms, prep_ms=prep_ms,
                               count_ms=parts["count_kernel"],
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=by, horizontal_bound_ms=hbound_ms))
        print(f"   {label}: N={u} K={k} W={w_words} C=2, {hits} contained "
              f"pairs, targets of {min(sizes)}-{max(sizes)} items: kernel "
              f"{ms:.4f} ms (median of 3 batches of {KERNEL_RUNS} back to "
              f"back), of which the layout pass {prep_ms:.4f} ms and the "
              f"count kernel {parts['count_kernel'] or float('nan'):.4f} ms "
              f"(profiled); bound {bound_ms:.4f} ms ({by}, "
              f"{kernel_model.kernel_flops(u, k, w_words, 2, hits, sizes):.4e}"
              f" int ops), kernel/bound {ms / bound_ms:.2f}; horizontal "
              f"bound {hbound_ms:.4f} ms, kernel/horizontal bound "
              f"{ms / hbound_ms:.2f}; plain {plain_ms:.3f} ms (median of "
              f"{PLAIN_RUNS})")
        if ms < bound_ms:
            raise AssertionError(f"{label}: kernel {ms:.4f} ms below its "
                                 f"bound {bound_ms:.4f} ms: the bound's "
                                 f"count is wrong")
    print("   kernels launched by this script: itemset_count")
    _done(t0)

    # ---- 4. streamed sweep: timing and copy/compute overlap ------------------
    from repro_torch.mining.stream import streaming_counts

    t0 = _phase(f"4. streamed sweep at the main-path geometries "
                f"(chunk_rows {STREAM_CHUNK_ROWS})")
    ub, uw = tx_d.cpu().numpy(), w_d.cpu().numpy()
    n_chunks = -(-u // STREAM_CHUNK_ROWS)
    trace_dir = ROOT / "build" / "traces"
    trace_dir.mkdir(parents=True, exist_ok=True)
    for (label, tgt_d), pl in zip(tgts, per_launch):
        tgt_h = tgt_d.cpu().numpy()
        # K3's bound: the 8 chunk launches' bounds, each with its hit count
        k3_bound = 0.0
        sizes = _target_sizes(tgt_d)
        for s0 in range(0, u, STREAM_CHUNK_ROWS):
            txc = tx_d[s0:s0 + STREAM_CHUNK_ROWS]
            hits_c = int(itemset_counts(txc, tgt_d, ones[s0:s0 + len(txc)],
                                        use_kernel=False).sum())
            k3_bound += kernel_model.predicted_seconds(
                txc.shape[0], pl["k"], w_words, 2, hits=hits_c,
                target_sizes=sizes) * 1e3
        pl["k3_bound_ms"] = k3_bound

        def sweep():
            return streaming_counts(ub, tgt_h, uw, chunk_rows=STREAM_CHUNK_ROWS,
                                    device=dev)

        want = itemset_counts(tx_d, tgt_d, w_d, use_kernel=False)
        if not torch.equal(sweep(), want):
            raise AssertionError(f"streamed sweep != plain version at {label}")
        walls = {}
        for timing in (True, False):
            obs.configure(kernel_timing=timing)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                sweep()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            walls[timing] = statistics.median(times)
        obs.configure(kernel_timing=True)
        trace = trace_dir / f"stream_{label.split()[0]}_{pl['k']}.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            sweep()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        kern, h2d = _device_intervals(trace)
        pl["k3_wall_ms"] = walls[False]
        acc = torch.zeros((pl["k"], 2), dtype=torch.int32, device=dev)

        def plain_sweep():
            acc.zero_()
            for s0 in range(0, u, STREAM_CHUNK_ROWS):
                itemset_counts_into(acc, tx_d[s0:s0 + STREAM_CHUNK_ROWS],
                                    tgt_d, w_d[s0:s0 + STREAM_CHUNK_ROWS],
                                    use_kernel=False)

        pl["k3_plain_ms"] = _time_ms(plain_sweep, 1, 0)
        line = (f"   {label}: K={pl['k']}, {n_chunks} chunks: sweep "
                f"{walls[True]:.3f} ms wall with kernel timing on, "
                f"{walls[False]:.3f} ms off (median of 3; one dense launch "
                f"{pl['ms']:.4f} ms); K3 bound {k3_bound:.4f} ms")
        if not kern:
            print(line + "; the profiler recorded no device events: overlap "
                  "not measured")
            continue
        ku, hu = _union(kern), _union(h2d)
        span = (max(e for _, e in ku + hu) - min(s for s, _ in ku + hu))
        busy = _length(_union(kern + h2d))
        hidden = _intersect(ku, hu)
        pl["k3_kernels_ms"] = _length(ku) / 1e3
        pl["k3_idle"] = 1 - busy / span
        if pl["k3_kernels_ms"] < k3_bound:
            raise AssertionError(f"{label}: the sweep's kernels took "
                                 f"{pl['k3_kernels_ms']:.4f} ms, below the "
                                 f"K3 bound {k3_bound:.4f} ms")
        print(line + f"; profiled: device span {span / 1e3:.3f} ms, kernels "
              f"{_length(ku) / 1e3:.3f} ms, H2D copies {_length(hu) / 1e3:.3f}"
              f" ms ({len(h2d)}), of which under kernels "
              f"{hidden / 1e3:.3f} ms ({hidden / max(_length(hu), 1e-9):.1%})"
              f", device idle {1 - busy / span:.1%} of the span")
    _done(t0)

    # ---- 5. main path at full size ------------------------------------------
    from repro_torch.mining import minority_report_dense

    t0 = _phase("5. minority_report_dense at 1,000,000 rows")
    print(f"   db: {len(tx_rows)} rows, {int(y.sum())} rare-class rows")

    def levels_total():
        return obs.counter_total(obs.snapshot(), "mine_levels_total")

    def run(label, **kw):
        lv0 = levels_total()
        ops.KERNEL_LAUNCHES = 0
        ops.KERNEL_LAUNCHES_INTO = 0
        t = time.perf_counter()
        res = minority_report_dense(
            tx_rows, y, min_support=MAIN["min_support"],
            min_confidence=MAIN["min_conf"], device=dev, **kw)
        torch.cuda.synchronize()
        launches = ops.KERNEL_LAUNCHES
        into = ops.KERNEL_LAUNCHES_INTO
        levels = int(levels_total() - lv0)
        print(f"   {label}: {res.engine} engine, {len(res.rules)} rules, "
              f"{levels} levels, kernel launches measured {launches} "
              f"(result field {res.kernel_launches}; {into} of them "
              f"accumulate-into), "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        return res, launches, levels, into

    dense, dense_launches, levels, _ = run("dense")
    if dense_launches != (levels - 1) + 1:
        raise AssertionError(f"dense: {dense_launches} launches, expected "
                             f"{levels - 1} kernel-counted levels + 1")
    streamed, stream_launches, s_levels, into_launches = run(
        "streamed", streaming=True, chunk_rows=STREAM_CHUNK_ROWS)
    if into_launches == 0:          # K3: the streamed sweep's launches
        raise AssertionError("the streamed main path launched no "
                             "accumulate-into kernel (K3)")
    if stream_launches != n_chunks * (s_levels + 1):
        raise AssertionError(f"streamed: {stream_launches} launches, "
                             f"expected {n_chunks} chunks x "
                             f"({s_levels} levels + 1)")
    plain, plain_launches, _, _ = run("plain version", use_kernel=False)
    if plain_launches != 0:
        raise AssertionError(f"plain run launched the kernel "
                             f"{plain_launches} times")
    rules = [astuple(r) for r in dense.rules]
    if not rules:
        raise AssertionError("main path found no rules")
    for label, other in (("streamed", streamed), ("plain", plain)):
        if [astuple(r) for r in other.rules] != rules:
            raise AssertionError(f"dense and {label} rule lists differ")
        if other.items_kept != dense.items_kept:
            raise AssertionError(f"dense and {label} items_kept differ")
    if dense.items_kept != items_kept:
        raise AssertionError("the main path kept other items than mra_encode")
    print(f"   rule lists identical: dense == streamed ({n_chunks} chunks) "
          f"== plain, {len(rules)} rules")
    _done(t0)

    # ---- 6. end to end against the host oracle -------------------------------
    from repro_torch.launch import mine as launch_mine

    t0 = _phase("6. launcher --verify at 200,000 rows")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_mine.main(["--rows", "200000", "--items", "60", "--p-x",
                          "0.125", "--p-y", "0.01", "--min-support", "1e-4",
                          "--min-conf", "0.01", "--verify"])
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("   "):
            print(f"   | {line}")
    if "rules identical" not in out:
        raise AssertionError("launcher did not verify against the host "
                             "oracle")
    _done(t0)

    # ---- 7. K2 against its plain version -------------------------------------
    t0 = _phase("7. tensor-core kernel (K2, accum=mxu_f32) == plain version")
    mxu_err = 0
    n_mxu = 0

    def check_mxu(tx, tgt, wts, label, acc0=None, want=None, **kw):
        nonlocal mxu_err, n_mxu
        if want is None:
            want = itemset_counts(tx, tgt, wts, use_kernel=False,
                                  accum="mxu_f32")
        if acc0 is None:
            got = itemset_counts(tx, tgt, wts, accum="mxu_f32", **kw)
        else:
            got = itemset_counts_into(acc0.clone(), tx, tgt, wts,
                                      accum="mxu_f32", **kw)
            want = acc0 + want
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        mxu_err = max(mxu_err, err)
        n_mxu += 1
        if not torch.equal(got, want):
            raise AssertionError(f"K2 != plain version at {label} "
                                 f"(max abs err {err})")

    for n, k, w, c in shapes:
        arrs = [torch.from_numpy(a).to(dev)
                for a in _random_problem(rng, n, k, w, c)]
        check_mxu(*arrs, f"N={n} K={k} W={w} C={c}")
        acc0 = torch.from_numpy(
            rng.integers(-1000, 1000, size=(k, c)).astype(np.int32)).to(dev)
        check_mxu(*arrs, f"accumulate N={n} K={k} W={w} C={c}", acc0=acc0)
    # every byte plane of every weight: full-range int32 weights against
    # K1's plain version (K2 folds the planes modulo 2^32, as int32 wraps)
    for n, k, w, c in ((5000, 100, 2, 2), (3001, 77, 5, 3), (2000, 33, 1, 1),
                       (70001, 300, 2, 2), (4000, 50, 65, 17)):
        tx, tgt, _ = _random_problem(rng, n, k, w, c)
        wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                           dtype=np.int64).astype(np.int32)
        tx, tgt, wts = [torch.from_numpy(a).to(dev) for a in (tx, tgt, wts)]
        check_mxu(tx, tgt, wts, f"full-range weights N={n} K={k} W={w} C={c}",
                  want=itemset_counts(tx, tgt, wts, use_kernel=False))
    n_mxu_knobs = 0
    for n, k, w, c in ((5000, 300, 2, 2), (4000, 70, 3, 1), (2000, 50, 65, 2),
                       (3000, 40, 2, 5)):
        arrs = [torch.from_numpy(a).to(dev)
                for a in _random_problem(rng, n, k, w, c)]
        want = itemset_counts(*arrs, use_kernel=False, accum="mxu_f32")
        # block_n sets K2's stage: 1024 rows and below, just above, 4096
        for bk, bn in itertools.product((1, 32, 96, 1024),
                                        (1, 96, 1025, 4096)):
            check_mxu(*arrs, f"N={n} K={k} block_k={bk} block_n={bn}",
                      want=want, block_k=bk, block_n=bn)
            n_mxu_knobs += 1
    near = [np.full((8, 1), 0xFFFFFFFF, np.uint32),
            np.array([[0], [1], [3]], np.uint32),
            np.full((8, 1), (1 << 21) - 1, np.int32)]
    near = [torch.from_numpy(a).to(dev) for a in near]
    check_mxu(*near, "near 2^24")
    if int(itemset_counts(*near, accum="mxu_f32")[0, 0]) != (1 << 24) - 8:
        raise AssertionError("K2 near 2^24: count is not 2^24 - 8")
    for label, tgt_d in tgts:
        check_mxu(tx_d, tgt_d, w_d, f"{label} K={tgt_d.shape[0]}")
        acc0 = torch.from_numpy(rng.integers(
            -1000, 1000, size=(tgt_d.shape[0], 2)).astype(np.int32)).to(dev)
        check_mxu(tx_d, tgt_d, w_d, f"accumulate {label}", acc0=acc0)
    print(f"   {n_mxu} comparisons (phase 2's {len(shapes)} shapes plain and "
          f"accumulate, 5 full-range weight shapes, {n_mxu_knobs} launch "
          f"knob settings, near 2^24 = {(1 << 24) - 8}, the 3 main-path "
          f"geometries plain and accumulate): equal, max abs err {mxu_err}")
    # K2's layout pass against its plain version, bit for bit
    n_planes = 0
    for n, _, w, c in shapes + [(999, 0, 300, 2), (u, 0, w_words, 2)]:
        if n == u:
            tx, wts = tx_d, w_d
        else:
            tx, _, _ = _random_problem(rng, n, 1, w, c)
            wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                               dtype=np.int64).astype(np.int32)
            tx, wts = (torch.from_numpy(a).to(dev) for a in (tx, wts))
        for bn in (512, 100) if n != u else (512,):
            got = ops.bit_slice(tx, wts, block_n=bn, accum="mxu_f32")
            planes, live = to_weight_planes(wts, got.stage_words)
            words = -(-n // 32)
            cols = got.columns.view(torch.int32)
            pl = got.planes.view(torch.int32)
            ok = (torch.equal(cols[:, :words],
                              to_item_columns(tx).view(torch.int32))
                  and not cols[:-1, words:].any()
                  and bool((cols[-1, words:] == -1).all())
                  and torch.equal(pl[..., :words], planes.view(torch.int32))
                  and not pl[..., words:].any()
                  and torch.equal(got.live.view(torch.int32),
                                  live.view(torch.int32))
                  and torch.equal(got.whole.view(torch.int32),
                                  whole_masks(wts).view(torch.int32)))
            if not ok:
                raise AssertionError(f"K2 layout pass != plain version at "
                                     f"N={n} W={w} C={c} block_n={bn}")
            n_planes += 1
    print(f"   K2 layout pass == to_item_columns / to_weight_planes / "
          f"whole_masks bit for bit: {n_planes} layouts (the main-path DB "
          f"included), pad words zero")
    _done(t0)

    # ---- 8. K2 timing --------------------------------------------------------
    t0 = _phase("8. the b1 product and K2 timing at the main-path geometries")
    obs.configure(kernel_timing=False)
    n_tiles = 0
    for _ in range(8):
        a, b = (torch.from_numpy(rng.integers(0, 2 ** 32, size=shape,
                                              dtype=np.uint32).view(np.int32))
                .to(dev).view(torch.uint32) for shape in ((16, 8), (8, 8)))
        if not torch.equal(b1_probe.b1_tile(a, b), b1_tile_ref(a, b)):
            raise AssertionError("b1 mma.sync tile != popc")
        n_tiles += 1
    b1_rate = b1_probe.mma_rate(True)
    u8_rate = b1_probe.mma_rate(False)
    whole = whole_masks(w_d)
    n_live = int(live_planes(whole).numel())
    plane_words = live_plane_words(w_d)
    print(f"   b1 mma.sync.m16n8k256 and.popc == popc on {n_tiles} random "
          f"tiles; measured mma.sync rates: b1 {b1_rate:.4e} bit op/s, u8 "
          f"m16n8k32 {u8_rate:.4e} op/s, b1/u8 {b1_rate / u8_rate:.3f} "
          f"(the model's b1 rate: 8 x the card's int8 rate = "
          f"{kernel_model.PEAK_B1_TENSOR_OPS:.4e}; mma.sync reaches "
          f"{b1_rate / kernel_model.PEAK_B1_TENSOR_OPS:.3f} of it)")
    print(f"   main-path weights: whole-launch masks "
          f"{[hex(int(x) & 0xFFFFFFFF) for x in whole.view(torch.int32)]}, "
          f"P = {n_live} live planes; live plane words {plane_words} of "
          f"{n_live * -(-u // 32)} (P in every row-word), "
          f"{plane_words / -(-u // 32):.3f} planes a row-word on average")
    per_launch_mxu = []
    for (label, tgt_d), pl in zip(tgts, per_launch):
        k = tgt_d.shape[0]

        def k2():
            return itemset_counts(tx_d, tgt_d, w_d, accum="mxu_f32")

        ms = _batch_ms(k2, KERNEL_RUNS)
        parts = _profiled_ms(k2, KERNEL_RUNS, ROOT / "build" / "traces" /
                             f"k2_{label.split()[0]}.json",
                             ("layout_kernel", "count_mxu_kernel"))
        plain_ms = _time_ms(
            lambda: itemset_counts(tx_d, tgt_d, w_d, use_kernel=False,
                                   accum="mxu_f32"), PLAIN_RUNS, 1)
        sizes = _target_sizes(tgt_d)
        bound_ms = kernel_model.predicted_seconds(
            u, k, w_words, 2, accum="mxu_f32", target_sizes=sizes,
            plane_words=plane_words) * 1e3
        b1_ms = kernel_model.b1_ops(k, plane_words) \
            / kernel_model.PEAK_B1_TENSOR_OPS * 1e3
        and_ms = kernel_model.and_ops(u, k, sizes) \
            / kernel_model.PEAK_INT32_OPS * 1e3
        by = kernel_model.bound_by(u, k, w_words, 2, accum="mxu_f32",
                                   target_sizes=sizes,
                                   plane_words=plane_words)
        # the first K2's bound: the byte-plane product at the int8 rate
        bp_ms = kernel_model.byte_plane_seconds(u, k, w_words, 2,
                                                target_sizes=sizes) * 1e3
        per_launch_mxu.append(dict(
            geometry=label, n=u, k=k, w=w_words, c=2, planes=n_live,
            plane_words=plane_words, ms=ms,
            prep_ms=parts["layout_kernel"],
            count_ms=parts["count_mxu_kernel"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, b1_ms=b1_ms, and_ms=and_ms,
            byte_plane_bound_ms=bp_ms, k1_ms=pl["ms"]))
        print(f"   {label}: N={u} K={k}: K2 {ms:.4f} ms (median of 3 "
              f"batches of {KERNEL_RUNS}), of which the layout pass "
              f"{parts['layout_kernel'] or float('nan'):.4f} ms and the count "
              f"kernel {parts['count_mxu_kernel'] or float('nan'):.4f} ms "
              f"(profiled); K1 {pl['ms']:.4f} ms (phase 3), K2/K1 "
              f"{ms / pl['ms']:.2f}; K2 bound {bound_ms:.4f} ms ({by}; AND "
              f"term {and_ms:.4f} ms, b1 term {b1_ms:.4f} ms), K2/bound "
              f"{ms / bound_ms:.2f}; byte-plane bound {bp_ms:.4f} ms, "
              f"K2/byte-plane bound {ms / bp_ms:.2f}; plain mxu_f32 "
              f"{plain_ms:.3f} ms (median of {PLAIN_RUNS})")
        if ms < bound_ms:
            raise AssertionError(f"{label}: K2 {ms:.4f} ms below its bound "
                                 f"{bound_ms:.4f} ms: the bound's count is "
                                 f"wrong")
    obs.configure(kernel_timing=True)
    _done(t0)

    # ---- 9. the autotune sweep ----------------------------------------------
    from repro_torch.launch import autotune as launch_autotune

    t0 = _phase("9. autotune sweep on the card (--preset main)")
    kind = autotune.device_kind()
    table_path = ROOT / "build" / "autotune" / f"{kind}.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_autotune.main(["--preset", "main", "--repeats", "3",
                              "--out", str(table_path)])
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"   | {line}")
    swept = autotune.load_table(str(table_path))
    if autotune.table_to_dict(swept) != json.loads(table_path.read_text()):
        raise AssertionError("swept table does not round-trip")
    main_buckets = {kernel_model.geometry_bucket(*g)
                    for g in launch_autotune.PRESETS["main"]}
    if set(swept.entries) != main_buckets:
        raise AssertionError(f"swept buckets {sorted(swept.entries)} != "
                             f"{sorted(main_buckets)}")
    for bucket, e in sorted(swept.entries.items()):
        cands = ", ".join(f"{key} {us:.1f}" for key, us in
                          sorted(e.candidates.items()))
        if not any(key.endswith("mxu_f32") for key in e.candidates):
            raise AssertionError(f"{bucket}: no mxu_f32 candidate swept")
        print(f"   {bucket}: winner bk{e.config.block_k}/{e.config.accum} "
              f"{e.us:.1f} us; candidates (us): {cands}; chunk candidates "
              f"{e.chunk_candidates}; serve {e.serve_candidates}")
    derived = autotune.derived_chooser_thresholds(swept)
    print(f"   table {table_path.relative_to(ROOT)} round-trips; derived "
          f"chooser thresholds: {derived or 'none (one row bucket)'}")
    _done(t0)

    # ---- 10. the tuned main path ---------------------------------------------
    t0 = _phase("10. tuned main path at 1,000,000 rows")

    def run_routes(label, **kw):
        for key in ops.KERNEL_LAUNCHES_BY_ACCUM:
            ops.KERNEL_LAUNCHES_BY_ACCUM[key] = 0
        t = time.perf_counter()
        res = minority_report_dense(
            tx_rows, y, min_support=MAIN["min_support"],
            min_confidence=MAIN["min_conf"], device=dev, **kw)
        torch.cuda.synchronize()
        by_route = dict(ops.KERNEL_LAUNCHES_BY_ACCUM)
        print(f"   {label}: {res.engine} engine, {len(res.rules)} rules, "
              f"launches by route {by_route}, "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        if [astuple(r) for r in res.rules] != rules:
            raise AssertionError(f"{label}: rules differ from phase 5")
        return by_route

    autotune.set_active_table(swept)
    run_routes(f"swept table ({autotune.describe_active()})")
    # mxu_f32 at every bucket the mine can touch: the whole DB and the
    # streamed chunks (131,072 rows and the ragged last one), every K
    pinned = {kernel_model.geometry_bucket(n, 1 << e, w_words, 2): {
        "block_k": 128, "block_n": 512, "accum": "mxu_f32", "chunk_rows": 0,
        "us": 1.0} for n in (u, STREAM_CHUNK_ROWS, u % STREAM_CHUNK_ROWS)
        for e in range(3, 21)}
    autotune.set_active_table(autotune.table_from_dict(
        {"schema": 1, "device_kind": kind, "entries": pinned}, "<pinned>"))
    mxu_routes = run_routes("pinned mxu_f32, dense")
    if mxu_routes["mxu_f32"] == 0 or mxu_routes["vpu_int32"] != 0:
        raise AssertionError(f"pinned mxu_f32 mine: launches {mxu_routes}")
    k3_mxu = run_routes("pinned mxu_f32, streamed (K3 through K2)",
                        streaming=True, chunk_rows=STREAM_CHUNK_ROWS)
    if k3_mxu["mxu_f32"] != stream_launches or k3_mxu["vpu_int32"] != 0:
        raise AssertionError(f"streamed mxu_f32 mine: launches {k3_mxu}, "
                             f"expected {stream_launches} K2 launches")
    print(f"   all three runs: the {len(rules)} rules of phase 5")
    autotune.set_active_table(swept)
    _done(t0)

    # ---- 11. the chooser and the GFP hybrid ----------------------------------
    from repro_torch.core.incremental import ceil_count
    from repro_torch.mining import (GFPBackend, backend_for_db,
                                    dense_mine_frequent, gfp_mine_frequent,
                                    mine_frequent_backend)

    t0 = _phase("11. chooser and GFP hybrid (swept table active)")
    backend, choice = backend_for_db(db)
    tr = choice.traits
    print(f"   backend_for_db on the 1M-row DB: {choice.name} "
          f"({choice.reason}); traits: {tr.n_rows} rows ({tr.n_unique} "
          f"unique, dedup {tr.dedup_ratio:.3f}), density {tr.density:.3f}, "
          f"skew {tr.skew:.2f}x, {tr.nbytes} bytes")
    min_count = ceil_count(MAIN["min_support"] * MAIN["n"])   # the MRA's
    t = time.perf_counter()
    want_freq = dense_mine_frequent(db, min_count, class_column=1)
    t_dense = time.perf_counter() - t
    for key in ops.KERNEL_LAUNCHES_BY_ACCUM:
        ops.KERNEL_LAUNCHES_BY_ACCUM[key] = 0
    gfp = GFPBackend(db)
    t = time.perf_counter()
    got_freq = mine_frequent_backend(gfp, min_count, class_column=1)
    torch.cuda.synchronize()
    t_gfp = time.perf_counter() - t
    gfp_routes = dict(ops.KERNEL_LAUNCHES_BY_ACCUM)
    if got_freq != want_freq or not got_freq:
        raise AssertionError("GFP hybrid frequent set != dense backend's")
    if gfp_mine_frequent(db, min_count, class_column=1, host_rows=0) \
            != want_freq:
        raise AssertionError("kernel-only GFP frequent set != dense's")
    print(f"   gfp_mine_frequent (rare class, min_count {min_count}): "
          f"{len(got_freq)} itemsets == dense backend's ({t_dense:.3f} s); "
          f"host_rows {gfp.host_rows}, {gfp.host_blocks} host blocks, "
          f"{gfp.kernel_launches} kernel launches "
          f"({gfp_routes} by route), "
          f"{gfp.blocks_counted} blocks, {t_gfp:.3f} s")
    for backend_name in ("auto", "gfp"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_mine.main(["--rows", "200000", "--items", "60", "--p-x",
                              "0.125", "--p-y", "0.01", "--min-support",
                              "0.01", "--backend", backend_name, "--verify"])
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"   | {line}")
        if "itemsets identical" not in out:
            raise AssertionError(f"launcher --backend {backend_name} did not "
                                 "verify against the host oracle")
    autotune.set_active_table(None)
    _done(t0)

    print(f"total seconds: {time.perf_counter() - t_all:.3f}")
    record = {"kernels": [{
        "name": "itemset_count",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/itemset_count.cu",
        "replaces": "src/repro/kernels/itemset_count/kernel.py:32",
        "launches": dense_launches,
        "max_abs_err": max_err,
        # the main path's work: one launch at each of its three geometries
        "ms": sum(p["ms"] for p in per_launch),
        "plain_ms": sum(p["plain_ms"] for p in per_launch),
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": per_launch[1]["bound_by"],
        "library_ms": None,
        "prep_ms": sum(p["prep_ms"] for p in per_launch),
        "horizontal_bound_ms": sum(p["horizontal_bound_ms"]
                                   for p in per_launch),
        "per_launch": per_launch,
    }, {
        "name": "itemset_count_mxu",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/"
                  "itemset_count_mxu.cu",
        "replaces": "src/repro/kernels/itemset_count/kernel.py:53",
        # the tuned main path under the table pinned to mxu_f32 (phase 10)
        "launches": mxu_routes["mxu_f32"],
        "max_abs_err": mxu_err,
        "ms": sum(p["ms"] for p in per_launch_mxu),
        "plain_ms": sum(p["plain_ms"] for p in per_launch_mxu),
        "bound_ms": sum(p["bound_ms"] for p in per_launch_mxu),
        "bound_by": per_launch_mxu[1]["bound_by"],
        "library_ms": None,
        "prep_ms": sum(p["prep_ms"] or 0.0 for p in per_launch_mxu),
        "count_ms": sum(p["count_ms"] or 0.0 for p in per_launch_mxu),
        "byte_plane_bound_ms": sum(p["byte_plane_bound_ms"]
                                   for p in per_launch_mxu),
        "planes": n_live,
        "plane_words": plane_words,
        "b1_rate": b1_rate,
        "u8_rate": u8_rate,
        "launches_streamed": k3_mxu["mxu_f32"],
        "per_launch": per_launch_mxu,
    }, {
        "name": "itemset_count_into",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/"
                  "itemset_count.cu (accumulate = 1)",
        "replaces": "src/repro/kernels/itemset_count/ops.py:138",
        # the streamed main path (phase 5): 8 chunks a level
        "launches": into_launches,
        "max_abs_err": max_err,
        # the 8-chunk sweeps at the three geometries: kernels in the trace
        "ms": (sum(p["k3_kernels_ms"] for p in per_launch)
               if all("k3_kernels_ms" in p for p in per_launch) else None),
        "plain_ms": sum(p["k3_plain_ms"] for p in per_launch),
        "bound_ms": sum(p["k3_bound_ms"] for p in per_launch),
        "bound_by": per_launch[1]["bound_by"],
        "library_ms": None,
        "wall_ms": sum(p["k3_wall_ms"] for p in per_launch),
        "launches_through_k2": k3_mxu["mxu_f32"],
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
