"""Mining launcher — the paper's workload on the card.

  PYTHONPATH=src python -m repro_torch.launch.mine --rows 20000 --items 60 \
      --p-x 0.12 --p-y 0.02 --min-support 0.001 --min-conf 0.2

Runs the Minority-Report pipeline on the dense (or, with ``--streaming``,
the out-of-core) engine; cross-validates the rule set against the
paper-faithful host implementation when ``--verify``.  ``--device cpu``
runs the plain PyTorch counting on the host instead of the CUDA kernel.

``--backend`` switches from the MRA pipeline (default ``mra``) to a plain
frequent-itemset mine through a chosen counting engine: ``auto`` consults
the adaptive chooser (``mining/chooser.py``) over measured DB traits and
prints its decision; ``dense``/``streaming``/``gfp`` force an engine.  The
banner names the active tuning table (``roofline/autotune.py``).
"""
import argparse
import sys
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--items", type=int, default=60)
    ap.add_argument("--p-x", type=float, default=0.12)
    ap.add_argument("--p-y", type=float, default=0.02)
    ap.add_argument("--min-support", type=float, default=0.001)
    ap.add_argument("--min-conf", type=float, default=0.05)
    ap.add_argument("--ckpt", default=None,
                    help="MiningCheckpoint path: per-chunk durable progress "
                         "(streaming engine), resume mid-level after a kill")
    ap.add_argument("--streaming", action="store_true",
                    help="force the out-of-core chunked engine (default: "
                         "auto-select by encoded DB size)")
    ap.add_argument("--chunk-rows", type=int, default=None,
                    help="rows per streamed chunk (default: staging-budget "
                         "heuristic, see mining/plan.py)")
    ap.add_argument("--backend", default="mra",
                    choices=["mra", "auto", "dense", "streaming", "gfp"],
                    help="mra (default): the full Minority-Report pipeline; "
                         "otherwise mine frequent itemsets through the named "
                         "engine — auto consults the adaptive chooser over "
                         "measured DB traits")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .. import obs
    from .._device import resolve_device
    from ..data import bernoulli_db
    from ..mining import MiningCheckpoint, minority_report_dense

    device = resolve_device(args.device)
    tx, y = bernoulli_db(args.rows, args.items, args.p_x, args.p_y, args.seed)
    print(f"db: {args.rows} rows, {args.items} items, "
          f"{int(y.sum())} rare-class rows; device {device}")

    ckpt = MiningCheckpoint(args.ckpt) if args.ckpt else None
    if ckpt is not None:
        state = ckpt.load_state()
        if state is not None:
            partial = state.get("partial")
            where = (f"mid-level {partial['level']} at chunk "
                     f"{partial['next_chunk']}" if partial
                     else f"level {state['level']} complete")
            print(f"resuming from checkpoint {args.ckpt}: {where}, "
                  f"{len(state['frequent'])} itemsets banked")

    from ..roofline import autotune

    print(f"autotune: {autotune.describe_active()}")

    if args.backend != "mra":
        _mine_backend(tx, args, ckpt, device)
        print(obs.summary_line())
        return
    t0 = time.time()
    res = minority_report_dense(
        tx, y, min_support=args.min_support, min_confidence=args.min_conf,
        streaming=True if args.streaming else None,
        chunk_rows=args.chunk_rows, checkpoint=ckpt, device=device)
    t_dense = time.time() - t0
    print(f"{res.engine} engine: {len(res.rules)} rules, "
          f"{res.kernel_launches} kernel "
          f"launches, {t_dense:.2f}s; items kept: {len(res.items_kept)}")
    for r in res.rules[:10]:
        print("  ", r)

    if args.verify:
        from ..core import minority_report
        t0 = time.time()
        host = minority_report(tx, y, min_support=args.min_support,
                               min_confidence=args.min_conf)
        t_host = time.time() - t0
        a = {r.antecedent: (r.count, r.g_count) for r in res.rules}
        b = {r.antecedent: (r.count, r.g_count) for r in host.rules}
        if a != b:
            raise SystemExit("dense/host rule mismatch!")
        print(f"verified against paper-faithful engine ({t_host:.2f}s): "
              f"{len(b)} rules identical")
    print(obs.summary_line())


def _mine_backend(tx, args, ckpt, device) -> None:
    """Plain frequent-itemset mine through a chooser-selected (or forced)
    counting backend, with the chooser's decision printed."""
    from ..core.incremental import ceil_count
    from ..mining import (DenseDB, StreamingDB, backend_for_db,
                          mine_frequent_backend)

    db = DenseDB.encode(tx, device=device)
    if args.backend == "streaming" and args.chunk_rows:
        db = StreamingDB.from_dense(db, args.chunk_rows)
    name = None if args.backend == "auto" else args.backend
    backend, choice = backend_for_db(db, name=name)
    print(f"backend: {choice.name} ({choice.reason})")
    if choice.traits is not None:
        t = choice.traits
        print(f"traits: {t.n_rows} rows ({t.n_unique} unique, "
              f"dedup {t.dedup_ratio:.2f}), density {t.density:.2f}, "
              f"skew {t.skew:.1f}x, {t.nbytes} bytes")

    min_count = ceil_count(args.min_support * len(tx))
    t0 = time.time()
    frequent = mine_frequent_backend(backend, min_count, checkpoint=ckpt)
    dt = time.time() - t0
    launches = getattr(backend, "kernel_launches", None)
    extra = "" if launches is None else (
        f", {launches} kernel launches, {backend.host_blocks} host blocks")
    print(f"{choice.name} engine: {len(frequent)} frequent itemsets at "
          f"min_count={min_count} in {dt:.2f}s{extra}")

    if args.verify:
        from ..core import mine_frequent
        t0 = time.time()
        want = mine_frequent(tx, min_count)
        t_host = time.time() - t0
        if frequent != want:
            raise SystemExit("backend/host frequent-set mismatch!")
        print(f"verified against paper-faithful engine ({t_host:.2f}s): "
              f"{len(want)} itemsets identical")


if __name__ == "__main__":
    main(sys.argv[1:])
