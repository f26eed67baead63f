"""Out-of-core mining demo: N beyond device residency, with kill/resume.

Builds a transaction DB, mines it with the streaming engine in small host
chunks (simulating a DB far larger than device memory), and demonstrates the
per-chunk checkpoint of the unified mining driver: the first mine is killed
mid-level, the second resumes from the last completed chunk and still
produces the exact rule set of the single-pass dense engine.

  PYTHONPATH=src python examples/torch/streaming_bigdata.py [--rows N] \
      [--chunk-rows C] [--ckpt mine.ckpt.json] [--backend auto] \
      [--device cuda|cpu]

With ``--ckpt PATH`` the resumable mine runs through the unified driver
(``repro_torch.mining.driver``) against that DURABLE path: Ctrl-C it mid-run,
re-run the same command, and it picks up from the last completed chunk —
the same ``MiningCheckpoint`` contract every backend (dense, streaming,
distributed, versioned serving store) now shares.  Without ``--ckpt`` the
kill/resume cycle is simulated in-process under a temp file.

``--backend`` selects the counting engine for the kill/resume mine:
``streaming`` (default — the out-of-core demo this example is about),
``dense``, ``gfp`` (the guided FP-growth hybrid), or ``auto`` — which asks
the adaptive chooser (``repro_torch.mining.chooser``) to pick from
MEASURED dataset traits and prints its decision and the traits it was based
on.  Every engine counts on ``--device`` (default: the card): each chunk of
the streamed sweeps is added into the running counts by the kernel's
accumulate-into launch.
"""
import argparse
import os
import tempfile
import time

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import minority_report
from repro_torch.data import bernoulli_db
from repro_torch.mining import (DenseDB, StreamingBackend, StreamingDB,
                                backend_for_db, mine_frequent_backend,
                                minority_report_dense)
from repro_torch.mining.checkpoint import MiningCheckpoint


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--chunk-rows", type=int, default=1024)
    ap.add_argument("--ckpt", default=None,
                    help="durable MiningCheckpoint path: kill this process "
                         "mid-mine and re-run to resume from the last chunk")
    ap.add_argument("--backend", default="streaming",
                    choices=["streaming", "auto", "dense", "gfp"],
                    help="counting engine for the kill/resume mine; auto "
                         "consults the adaptive chooser over measured traits")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rows, chunk_rows = args.rows, args.chunk_rows

    tx, y = bernoulli_db(rows, 40, p_x=0.15, p_y=0.03, seed=7)
    print(f"db: {rows} rows, chunked at {chunk_rows} rows/chunk")

    # ---- streaming MRA == host-faithful MRA --------------------------------
    t0 = time.time()
    res = minority_report_dense(tx, y, min_support=0.002, min_confidence=0.02,
                                streaming=True, chunk_rows=chunk_rows,
                                device=device)
    t_stream = time.time() - t0
    host = minority_report(tx, y, min_support=0.002, min_confidence=0.02)
    a = {r.antecedent: (r.count, r.g_count) for r in res.rules}
    b = {r.antecedent: (r.count, r.g_count) for r in host.rules}
    assert a == b, (len(a), len(b))
    print(f"{res.engine} engine: {len(res.rules)} rules in {t_stream:.2f}s "
          f"(== host-faithful MRA)")

    # ---- kill/resume through the unified driver ----------------------------
    sdb = StreamingDB.encode(tx, chunk_rows=chunk_rows, device=device)
    if args.backend == "streaming":
        backend = StreamingBackend(sdb)
    else:
        # the chooser path: measure the encoded DB, pick (or force) an
        # engine, and say why — every engine speaks the same driver protocol,
        # so the kill/resume flow below is unchanged
        name = None if args.backend == "auto" else args.backend
        backend, choice = backend_for_db(DenseDB.encode(tx, device=device),
                                         name=name)
        print(f"backend: {choice.name} ({choice.reason})")
        if choice.traits is not None:
            t = choice.traits
            print(f"traits: {t.n_rows} rows ({t.n_unique} unique, dedup "
                  f"{t.dedup_ratio:.2f}), density {t.density:.2f}, "
                  f"skew {t.skew:.1f}x, {t.nbytes} bytes")
    min_count = rows * 0.01

    if args.ckpt:
        # durable mode: progress survives THIS process — kill and re-run
        ckpt = MiningCheckpoint(args.ckpt)
        state = ckpt.load_state()
        if state is not None:
            partial = state.get("partial")
            where = (f"mid-level {partial['level']}, chunk "
                     f"{partial['next_chunk']}" if partial
                     else f"level {state['level']} complete")
            print(f"resuming {args.ckpt}: {where}")
        chunks = []
        got = mine_frequent_backend(
            backend, min_count, checkpoint=ckpt,
            on_chunk=lambda lvl, c: chunks.append((lvl, c)))
        want = mine_frequent_backend(backend, min_count)
        assert got == want
        print(f"driver mine complete: {len(got)} frequent itemsets after "
              f"{len(chunks)} chunk-counts this run (== uninterrupted run); "
              f"delete {args.ckpt} to start fresh")
        print(obs.summary_line())
        return

    # simulated mode: preempt mid-level in-process, then resume
    fd, ckpt_path = tempfile.mkstemp(suffix=".mine.json")
    os.close(fd)
    ckpt = MiningCheckpoint(ckpt_path)
    n_chunks = backend.n_count_chunks
    budget = n_chunks + n_chunks // 2          # die mid-way through level 2

    class _Preempted(Exception):
        pass

    seen = []

    def die_midway(level, chunk):
        seen.append((level, chunk))
        if len(seen) >= budget:
            raise _Preempted()

    preempted = False
    try:
        mine_frequent_backend(backend, min_count, checkpoint=ckpt,
                              on_chunk=die_midway)
        print("db too small to be preempted mid-level; try more rows")
    except _Preempted:
        preempted = True
        level, chunk = seen[-1]
        print(f"killed at level {level}, chunk {chunk + 1}/{n_chunks}")

    if preempted:
        resumed = []
        got = mine_frequent_backend(backend, min_count, checkpoint=ckpt,
                                    on_chunk=lambda l, c:
                                    resumed.append((l, c)))
        want = mine_frequent_backend(backend, min_count)
        assert got == want
        print(f"resumed at level {resumed[0][0]}, chunk {resumed[0][1] + 1}"
              f" — {len(resumed)} chunk-counts instead of "
              f"{len(seen) + len(resumed)}+; {len(got)} frequent itemsets, "
              f"identical to uninterrupted run")
    os.unlink(ckpt_path)
    print(obs.summary_line())


if __name__ == "__main__":
    main()
