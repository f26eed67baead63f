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
   rows, W = 2, C = 2, K = 1,770 / 34,220 / 1,830).
3. Timing at the main-path geometries: kernel median over CUDA-event-timed
   runs, the roofline bound of ``roofline/kernel_model.py`` with this
   data's hit count, the plain version's median.
4. The streamed sweep at those geometries (8 chunks): its time with kernel
   timing on and off, and a ``torch.profiler`` trace of it, read for how
   much of the host-to-device copy time the kernels hide.
5. The main path at full size: ``minority_report_dense`` on the same DB,
   dense, streamed in 8 chunks, and with the plain version; identical
   rules, and the kernel's launch counter read around each run.
6. ``repro_torch.launch.mine --verify`` at 200,000 rows against the host
   oracle.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import contextlib
import io
import itertools
import json
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
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.kernels.itemset_count.ops import (itemset_counts,
                                                       itemset_counts_into)
    from repro_torch.roofline import kernel_model

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
    ops.build()
    print(f"   nvcc build of itemset_count.cu: "
          f"{_build.BUILD_SECONDS.get('itemset_count', 0.0):.3f} s "
          f"(load {time.perf_counter() - tb:.3f} s) -> "
          f"{_build.library_path(ops.SOURCE).relative_to(ROOT)}")
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
    _done(t0)

    # ---- 3. timing -----------------------------------------------------------
    t0 = _phase("3. timing at the main-path geometries")
    obs.configure(kernel_timing=False)   # the events below time the launches
    ones = torch.ones((u, 1), dtype=torch.int32, device=dev)
    per_launch = []
    for label, tgt_d in tgts:
        k = tgt_d.shape[0]
        # contained (row, target) pairs: the data-dependent part of the work
        hits = int(itemset_counts(tx_d, tgt_d, ones, use_kernel=False).sum())
        ms = _time_ms(lambda: itemset_counts(tx_d, tgt_d, w_d), KERNEL_RUNS, 2)
        plain_ms = _time_ms(
            lambda: itemset_counts(tx_d, tgt_d, w_d, use_kernel=False),
            PLAIN_RUNS, 1)
        bound_ms = kernel_model.predicted_seconds(u, k, w_words, 2,
                                                  hits=hits) * 1e3
        by = kernel_model.bound_by(u, k, w_words, 2, hits=hits)
        per_launch.append(dict(geometry=label, n=u, k=k, w=w_words, c=2,
                               hits=hits, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=by))
        print(f"   {label}: N={u} K={k} W={w_words} C=2, {hits} contained "
              f"pairs: kernel {ms:.4f} ms (median of {KERNEL_RUNS}), bound "
              f"{bound_ms:.4f} ms ({by}, "
              f"{kernel_model.kernel_flops(u, k, w_words, 2, hits):.4e} int "
              f"ops), plain {plain_ms:.3f} ms (median of {PLAIN_RUNS}); "
              f"kernel/bound {ms / bound_ms:.2f}")
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
        line = (f"   {label}: K={pl['k']}, {n_chunks} chunks: sweep "
                f"{walls[True]:.3f} ms wall with kernel timing on, "
                f"{walls[False]:.3f} ms off (median of 3; one dense launch "
                f"{pl['ms']:.4f} ms)")
        if not kern:
            print(line + "; the profiler recorded no device events: overlap "
                  "not measured")
            continue
        ku, hu = _union(kern), _union(h2d)
        span = (max(e for _, e in ku + hu) - min(s for s, _ in ku + hu))
        busy = _length(_union(kern + h2d))
        hidden = _intersect(ku, hu)
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
        t = time.perf_counter()
        res = minority_report_dense(
            tx_rows, y, min_support=MAIN["min_support"],
            min_confidence=MAIN["min_conf"], device=dev, **kw)
        torch.cuda.synchronize()
        launches = ops.KERNEL_LAUNCHES
        levels = int(levels_total() - lv0)
        print(f"   {label}: {res.engine} engine, {len(res.rules)} rules, "
              f"{levels} levels, kernel launches measured {launches} "
              f"(result field {res.kernel_launches}), "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        return res, launches, levels

    dense, dense_launches, levels = run("dense")
    if dense_launches != (levels - 1) + 1:
        raise AssertionError(f"dense: {dense_launches} launches, expected "
                             f"{levels - 1} kernel-counted levels + 1")
    streamed, stream_launches, s_levels = run(
        "streamed", streaming=True, chunk_rows=STREAM_CHUNK_ROWS)
    if stream_launches != n_chunks * (s_levels + 1):
        raise AssertionError(f"streamed: {stream_launches} launches, "
                             f"expected {n_chunks} chunks x "
                             f"({s_levels} levels + 1)")
    plain, plain_launches, _ = run("plain version", use_kernel=False)
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
        "launches_streamed": stream_launches,
        "per_launch": per_launch,
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
