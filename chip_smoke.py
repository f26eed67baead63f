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
12. The disk tier at the spill threshold, untuned: a DB of 136,000,000
    rows x 60 items (W = 2, each bit set with p = 1/8, a rare class with
    p_y = 0.01, one-hot weights, not deduplicated; 2.176e9 bytes, just over
    ``DEFAULT_SPILL_THRESHOLD_BYTES`` = 2^31), generated blockwise from
    seed 0 and made a resident ``DenseDB``; ``backend_for_db`` must pick
    ``spilled`` by itself and spill into ``build/spill/`` (the write's time
    and rate from the ``spill.write`` span); ``SpilledDB.open`` the store
    again; ``spilled_counts`` at K = 60, 1,770 and 34,220, prefetch on and
    off, each ``torch.equal`` to K1's one dense pass, with the segments,
    bytes read, wall time, read rate, prefetch hit ratio, a
    ``torch.profiler`` trace's kernel time and device idle share, and K3's
    bound summed over the segments; four pairs counted in numpy over all
    rows; the pair sweep again after the segments are dropped from the page
    cache; the ``SpilledBackend`` mine at min_count ceil(0.01 N) equal to
    the ``DenseBackend`` mine (60 singles and 1,770 pairs), and again under
    a table pinned to ``mxu_f32`` (K3 through K2).  The store is deleted at
    the end.
13. The mesh runtime on the one card, untuned: (a) one NCCL rank, mesh
    (1, 1): ``distributed_counts`` at the main-path geometries (and level 2
    less one target) equal to K1's dense counts and ``DistributedMiner``'s
    mine equal to the dense mine; (b) two gloo ranks sharing the card
    (``torch.multiprocessing``, a ``FileStore`` under ``build/mesh/``,
    joined with a timeout), meshes (2, 1) and (1, 2), each rank counting its
    shard or target block with K1 on the card and checking the counts and
    the mine itself; then a chunked mine (chunk_rows 131,072) on (2, 1)
    stopped after chunk 3 of level 3 and resumed from rank 0's checkpoint
    on the (1, 1) NCCL mesh, equal to the uninterrupted mine.  Each rank's
    per-launch kernel time (the wrapper's CUDA events) and the all-reduce's
    time and bytes are printed.
14. The count server, untuned: ``CountServer(tx, classes=y, n_classes=2)``
    on the card over phase 5's 1,000,000 transactions (the build's encode,
    dedup and upload seconds; a dense base of 969,130 rows; the chooser's
    verdict; the serve block_k); every served count below held against
    the plain version over the same resident tensors (all 1,770 pairs and
    34,220 triples).  (1) Per-flush latency at batches of 1, 4, 16, 64 and
    256 distinct single-query requests, 20 flushes each, cold (a fresh
    cache: one K1 launch a flush, asserted) and warm (cache hits: no
    launch), median and p99 wall ms.  (2) Ten cold flushes at batch 1 and
    at 64 under ``torch.profiler``: the layout pass, the count kernel, the
    host's share of the wall and the device's idle share of its span.  (3)
    One flush of all 34,220 triples beside phase 3's level-3 K1 time.  (8)
    Under a table pinned to ``mxu_f32``: cold flushes at batch 64 and of
    all triples through K2.  (6) ``mine(1e-4, class_column=1)`` with
    ``backend="store"`` and ``"auto"`` (the chooser's verdict printed) equal
    to phase 11's rare-class mine.  (4) An append of 10,000 rows (seed 1):
    a cold flush makes 2 launches (base + delta) and equals a fresh plain
    count of all 1,010,000 rows (the rows packed again in numpy from the
    generator's draws); ``compact()`` inline, with the base's D2H copy
    alone.  (6) ``mine(0.01)``, an append of 10,000 rows (seed 2) with the
    incremental refresh, equal to a fresh mine of the whole history.  (5)
    A server over the first 200,000 rows with background compaction and
    async flush: four client threads submit 256 single queries each while
    8 appends of 2,000 rows land; every future equals the count at a
    version between its submit and the last append; the flush latency
    p50 / p99 / max and the compactions.  (7) Streamed and spilled bases
    (``build/spill_serve/``) of those 200,000 rows plus a 2,000-row delta:
    cold flushes at batch 64 and K = 1,770, exact, with the chunks plus one
    launches.  (9) ``ShardedDB(n_shards=2)`` over a one-rank NCCL mesh (a
    FileStore under ``build/mesh_serve/``) equal to the unsharded store
    before and after an append that widens W to 4, then two gloo ranks
    sharing the card on mesh (2, 1) (``chip_smoke._serve_rank``), each
    checking its own counts and refusing ``async_flush``; per-flush wall
    ms and the all-reduce's ms.
15. The rule server, the exporter, the lock watcher and the launcher,
    untuned.  (1) ``RuleServer`` over a second ``CountServer`` of phase 5's
    1,000,000 transactions: ``top_rules(1e-4, 0.01)`` equal to phase 5's
    rules in order, and with ``optimal=True`` to ``optimal_rule_set`` of
    them, with the mine's chooser verdict (``dense``) and seconds;
    ``rules_for`` of all 1,770 pairs and 34,220 triples at min_conf 0.01
    equal to rules made from the plain version's counts; per-call wall ms
    of ``rules_for`` at 1, 64 and 256 antecedents, cold (fresh caches: one
    K1 launch a call) and warm (rule-cache hits: none), median and p99 of
    20 calls, and the rule cache's hit rate; an append of 10,000 rows (seed
    1) through the rule server, after which the 8 prefetched hottest keys
    are answered from the rule cache and equal rules from a fresh plain
    count of all rows packed again in numpy.  (2) ``start_metrics_server(0)``
    during that traffic: ``/metrics`` and ``/metrics.json`` fetched with
    ``urllib``, ``serve_flush_ms_count`` in the text equal to the
    snapshot's.  (3) ``instrument_server`` on phase 14 (5)'s 200,000-row
    async server with background compaction, a ``RuleServer`` over it: four
    threads race ``rules_for`` and ``submit_async`` against 8 appends of
    2,000 rows through the rule server; no lock-order cycle, the server ->
    flusher and store -> compactor edges observed, every verdict and future
    exact at a version between its call and the last append.  (4)
    ``python -m repro_torch.launch.serve_counts --rows 200000 --items 60
    --p-x 0.125 --p-y 0.01 --verify`` as subprocesses, the variants side
    by side: (a) ``--rules --theta 0.001 --min-conf 0.01 --appends 2
    --append-rows 2000`` with a metrics dump and a trace under
    ``build/serve_counts/``, (b) ``--shards 2 --async-flush --max-delay-ms
    25 --theta 0.001``, (c) ``--spill-dir build/spill_launch
    --spill-threshold-bytes 4096 --bg-compact --min-compact-rows 64
    --theta 0.001`` twice into the same directory (the second run's
    store claims generations of its own beside the first's), (d)
    ``--shards 2 --mesh-data 1`` on
    a one-rank NCCL group; each must exit 0 with its verified lines; its
    wall seconds and the wrapper's launch counters from its output.

16. The model zoo's serving path (``repro_torch.models``,
    ``repro_torch.launch.serve``; plain PyTorch, no kernel of this repo).
    (a) Every arch at its reduced config in float32: the port on the card
    against the port on the CPU, weights from one CPU generator copied
    across: forward logits, prefill's logits and cache, 4 decode steps,
    ``rtol = atol = 1e-4`` (TF32 off).  (b) qwen3-8b at full width and
    depth in bf16 (36 layers, 8.19e9 parameters): ``python -m
    repro_torch.launch.serve --arch qwen3-8b`` (batch 4, prompt 32, gen 16)
    run in-process twice from seed 0 (the same greedy tokens), then a batch
    4 x 2,048 prefill (4 q-blocks of 512) and 31 greedy decode steps into a
    4 x 2,080 cache.  (c) mamba2-2.7b at full width and depth in bf16 (64
    layers): the launcher with a 512-token prompt (2 SSD chunks of 256) and
    16 decode steps, twice.  In (b) and (c) the logits of prefill and of
    every decode step are held against ``forward`` over the whole sequence:
    the relative L2 error of each row over the real vocabulary at most
    ``_bf16_tol(layers)``.  Prefill and decode times, tokens/s and
    ``torch.cuda.max_memory_allocated`` against the weights and the cache.

17. The training path (``repro_torch.train``, ``checkpoint``, ``data``,
    ``launch.train``; plain PyTorch, no kernel of this repo).  (a) Every
    arch at its reduced config in float32: one ``train_step`` on the card
    against the same step on the host from the same weights and batch
    (loss, ``grad_norm``, every gradient within 1e-4 of its parameter's
    largest entry), then AdamW on the host from the card's gradients
    against the card's update (float32 rounding).  (b) Reduced qwen3-8b,
    15 steps: the loss falls by 0.1.  (c) 4 microbatches equal 1.  (d)
    Under ``torch.use_deterministic_algorithms``: save at step 3, restore,
    steps 3-5, bit for bit, every reduced arch in float32 and qwen3-8b in
    bf16 (an arch that runs an op with no deterministic CUDA version is
    named and not restarted; qwen3-8b must restart).  (e) ``python -m
    repro_torch.launch.train --arch qwen3-8b --reduced`` under
    ``build/train_launch/``: SIGTERM after its first checkpoint, then
    ``--resume``.  (f) ``--data-mesh 2 --dist-backend gloo`` as two ranks
    sharing the card against one NCCL rank on the whole batch: the same
    logged losses, parameters within the microbatch tolerance.  (g)
    mamba2-2.7b at full width and depth and (h) qwen3-8b at full width,
    20 of its 36 layers (the full depth's weights, gradients and float32
    moments need 98.3 GB), bf16, ``cfg.remat`` on, TRAIN_4K's length
    (batch 2 and 1), 6 steps on ``TokenPipeline`` batches: step ms, tok/s,
    model FLOPs against the dense bf16 peak, the AdamW update's ms apart
    (CUDA events), peak memory against the predicted, a ``torch.profiler``
    trace of the last step (``build/traces/train_<arch>.json``); every loss
    and norm finite, the first loss equal to ``Model.loss`` without grad
    within ``_bf16_tol(layers)``, and the clip's norm equal to one taken
    again from the ``.grad`` tensors.

18. Tensor and expert parallelism over a 'model' mesh axis
    (``parallel/collectives.py``, ``Model(mesh=)``; plain PyTorch, no
    kernel of this repo), on gloo ranks sharing the card.  (a) Every arch at
    its reduced config in float32 on meshes (2, 2) (four ranks) and (1, 2)
    (two), each rank against a 1 x 1 run of the same weights on the card:
    forward, prefill (its cache split over 'model'), 4 decode steps and a
    train step; logits within ``TP_F32_TOL`` of the largest, the loss
    within ``TP_LOSS_RTOL``, every gradient within ``TP_GRAD_TOL`` of its
    parameter's largest entry.  On (1, 2) against rank 0's 1 x 1 run, in
    bf16: (b) arctic-480b and (c) llama4-maverick-400b-a17b at full width,
    1 layer, and (d) qwen3-32b at full width and depth, each a 1 x 512
    prefill into 528 positions and 16 decode steps fed the 1 x 1 run's
    greedy tokens, the logits' relative L2 within ``_bf16_tol(layers)``;
    prefill ms, decode ms a step, kernels a step (``torch.profiler``), the
    collectives' share of the wall (``collectives.STATS``) and peak memory a
    rank.  Where (d)'s relative L2 comes from: each of its two runs' logits
    against a bf16 forward of the same mesh over the same sequence, and, at
    ``TP_F32_CUT`` layers, the bf16 forward on 1 x 1 and on 1 x 2 each
    against a float32 1 x 1 forward of the same bf16 weights, within
    ``_bf16_tol(layers)``.  (e) qwen3-8b at full width, 8 layers, 2 train
    steps at 1 x 2,048, losses and clip norms within ``_tp_limit_train``.
    The sizes of the archs one card holds only in part are printed first,
    and the time of one gloo all-reduce and all-gather on the card by
    size.
19. The dry run (``launch/dryrun.py``, ``launch/specs.py``,
    ``roofline/count.py``; plain PyTorch, no kernel) against the card.
    Its counts of each cell run in a process of their own on fake ``cuda``
    tensors, beside the card runs.  (a) qwen3-8b, mistral-nemo-12b,
    starcoder2-7b, seamless-m4t-large-v2 (with frames) and chameleon-34b
    whole in bf16 on 1 x 1, each a ``DRY_BATCH`` x ``DRY_PROMPT`` prefill
    into ``DRY_MAX_LEN`` positions and ``DRY_STEPS`` decode steps: the
    FLOPs ``FlopCounterMode`` counts over the card's prefill and first
    decode step equal to the dry run's count of the same cell, the
    argument bytes equal to the real tensors', the predicted peak within
    ``DRY_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated`` (less what
    was live before the step and is no argument), a decode step's device
    busy time (``torch.profiler``) and wall time against the roofline's
    ``step_time`` (an impossible reading, busy below the bound, fails),
    and the prefill and decode logits against ``forward`` over the whole
    sequence within ``_bf16_tol(layers)``.  (b) qwen3-8b cut to
    ``DRY_TP`` layers on two gloo ranks sharing the card, (1, 2): the
    collectives of one decode step and one train step, counted at the
    dispatcher, equal in kind, group, number and bytes to the dry run's on
    a fake (1, 2) group.
20. The seven examples under ``examples/torch/`` on the card, in this
    process (``runpy`` with ``sys.argv`` set and ``--device cuda``, no call
    wrapped in ``try``: an example's failed assertion fails the phase), the
    tuning table unset: each at its default arguments
    (``minority_report_census`` at ``EXAMPLE_CENSUS_PY``), then
    ``streaming_bigdata`` with ``--backend streaming`` at
    ``EXAMPLE_STREAM_ROWS`` rows and ``--backend auto`` at
    ``EXAMPLE_BIG_ROWS``, and ``count_server EXAMPLE_BIG_ROWS``, each with
    its own host oracle; the cuts (``EXAMPLE_CUTS``) are printed first.  For each run: the wall time, the
    exactness line the example prints, and K1's, K2's and K3's launches
    (``ops.KERNEL_LAUNCHES_BY_ACCUM`` and ``KERNEL_LAUNCHES_INTO`` read
    before and after).  Fails unless every example that counts on the
    device launched K1 or K3, and unless the wrapper's plain version
    (``ops.itemset_counts_ref_blocked``, counted for the phase) ran no
    time.  Then ``python -m repro_torch.launch.analyze --self-test`` and
    the lint's gate on this host, both exiting 0.  (``_example_oracles``,
    not a phase, times the 1M-row runs' host oracles apart.)

The last lines are the card's name and power limit, the kernels' JSON
record (K1, K2 and K3, the accumulate-into launch; with the launches on the
spilled path, on each rank of each mesh, and on the count server's, the
rule server's, the launcher's and the examples' paths counted apart in
``launches_by_path``), phase 16's ``models`` record, phase 17's ``train``
record, phase 18's ``tensor_parallel`` record, phase 19's ``dryrun``
record, phase 20's ``examples`` record and ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import contextlib
import io
import itertools
import json
import math
import os
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
# Phase 12's DB: just over the disk tier's 2 GiB host-RAM budget (the §4.3
# Bernoulli model, p_x = 1/8, unit one-hot weights, not deduplicated).
SPILL_DB = dict(n=136_000_000, items=60, p_y=0.01, seed=0)
SPILL_PAIRS = ((0, 1), (17, 42), (31, 32), (58, 59))   # the numpy check
MESH_JOIN_S = 300
MESH_KILL = (3, 3)      # the two-rank chunked mine stops after this chunk
# Phase 16's tolerances.  float32 on the card against float32 on the CPU:
# the same operations, summed in another order.  bf16 prefill and decode
# against a bf16 forward over the whole sequence, as the relative L2 error
# of each logits row: every product and activation is rounded to 8
# significant bits (2^-8) at other places in the two paths (other shapes,
# other cuBLAS tiles, the SSD state carried step by step in bf16), a few
# roundings a layer (2^-6), and independent layers add in quadrature
# (sqrt(layers)): 0.094 at qwen3-8b's 36 layers, 0.125 at mamba2-2.7b's 64.
# (A 64-layer mamba2 of width 512 on the CPU showed 0.067.)  A wrong
# position, mask or state is an error of order 1.
ZOO_F32_TOL = 1e-4


def _bf16_tol(n_layers):
    return 2.0 ** -6 * n_layers ** 0.5


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(t0):
    print(f"   phase seconds: {time.perf_counter() - t0:.3f}", flush=True)


def _encode_kernels_equal(tx_rows, y, items_kept, dev) -> None:
    """Each MRA encode kernel (``kernels/mra_encode``) against its plain
    PyTorch version on the same card tensors, the main path's walk."""
    import numpy as np
    import torch

    from repro_torch.kernels.mra_encode import ops, ref
    from repro_torch.mining.encode import walk_rows

    t = time.perf_counter()
    walk = walk_rows(tx_rows)
    offsets = np.zeros(len(walk.lengths) + 1, np.int64)
    np.cumsum(walk.lengths, out=offsets[1:])
    ids = torch.from_numpy(walk.ids).to(dev)
    offsets = torch.from_numpy(offsets).to(dev)
    rare = torch.from_numpy((np.asarray(y) == 1).view(np.uint8)).to(dev)
    n_ids = len(walk.items)
    ref_ids = ids.clone()
    checks = [("count_rows", ops.count_rows(ids, offsets, rare, n_ids),
               ref.count_rows_ref(ref_ids, offsets, rare, n_ids)),
              ("count_rows' sorted rows", ids, ref_ids)]
    id_of = {a: i for i, a in enumerate(walk.items)}
    cols = torch.full((n_ids,), -1, dtype=torch.int32)
    for j, a in enumerate(items_kept):
        cols[id_of[a]] = j
    cols = cols.to(dev)
    w = max(1, -(-len(items_kept) // 32))
    words, wkeys = ops.pack_rows(ids, offsets, cols, w)
    rwords, rkeys = ref.pack_rows_ref(ids, offsets, cols, w)
    checks += [("pack_rows words", words, rwords),
               ("pack_rows keys", wkeys, rkeys)]
    perm = None
    for p in range(wkeys.shape[0] - 1, -1, -1):
        idx = torch.argsort(wkeys[p] if perm is None else wkeys[p][perm],
                            stable=True)
        perm = idx if perm is None else perm[idx]
    head = ops.row_heads(words, perm)
    checks.append(("row_heads", head, ref.row_heads_ref(words, perm)))
    run = head.cumsum(0, dtype=torch.int32)
    runs = int(run[-1])
    got = ops.gather_rows(words, perm, run, head, rare, runs)
    want = ref.gather_rows_ref(words, perm, run, head, rare, runs)
    checks += [("gather_rows bits", got[0], want[0]),
               ("gather_rows weights", got[1], want[1])]
    torch.cuda.synchronize()
    for name, g, x in checks:
        if g.dtype != x.dtype or not torch.equal(g, x):
            raise AssertionError(f"encode kernel {name} != plain version on "
                                 f"the main path's walk")
    print(f"   encode kernels == plain version on the main path's walk "
          f"({len(walk.lengths)} rows, {ids.numel()} occurrences, {n_ids} "
          f"walked items, W={w}, {runs} runs): count_rows, pack_rows, "
          f"row_heads, gather_rows equal "
          f"({time.perf_counter() - t:.3f} s)")


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


def _bernoulli_db(n, p_y, seed, block=1 << 23):
    """Phase 12's DB, blockwise from ``seed``: 60 item bits a row (W = 2),
    each set with p = 1/8 as the AND of three uniform words, bits 60-63
    off; a rare class with ``p_y``; one-hot int32 weights (C = 2)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    bits = np.empty((n, 2), np.uint32)
    w = np.empty((n, 2), np.int32)
    for s in range(0, n, block):
        e = min(s + block, n)
        b = rng.integers(0, 2 ** 32, size=(e - s, 2), dtype=np.uint32)
        b &= rng.integers(0, 2 ** 32, size=(e - s, 2), dtype=np.uint32)
        b &= rng.integers(0, 2 ** 32, size=(e - s, 2), dtype=np.uint32)
        b[:, 1] &= np.uint32((1 << 28) - 1)
        bits[s:e] = b
        y = rng.random(e - s) < p_y
        w[s:e, 1] = y
        w[s:e, 0] = ~y
    return bits, w


def _numpy_pair_counts(bits, w, pairs, block=1 << 23):
    """Per-class counts of item pairs over all rows, in numpy: the check
    that shares no code with the port."""
    import numpy as np
    out = np.zeros((len(pairs), w.shape[1]), np.int64)
    one = np.uint32(1)
    for s in range(0, len(bits), block):
        b, ww = bits[s:s + block], w[s:s + block]
        for i, (x, y) in enumerate(pairs):
            hit = ((b[:, x >> 5] >> np.uint32(x & 31))
                   & (b[:, y >> 5] >> np.uint32(y & 31)) & one).astype(bool)
            out[i] += ww[hit].sum(axis=0)
    return out


def _evict(directory):
    """Drop a store's files from the page cache (clean pages only: the
    spill fsync'd them), so the next sweep reads the disk."""
    for name in os.listdir(directory):
        fd = os.open(os.path.join(directory, name), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def _launch_ms(obs, fn):
    """``fn()`` and its kernels' mean device time per launch (CUDA events
    of the wrapper's kernel timing), or None without a launch."""
    from repro_torch.obs import counter_total
    before = obs.snapshot()
    out = fn()
    after = obs.snapshot()
    n = (counter_total(after, "kernel_launches_total")
         - counter_total(before, "kernel_launches_total"))
    s = (counter_total(after, "kernel_measured_s_total")
         - counter_total(before, "kernel_measured_s_total"))
    return (s / n * 1e3 if n else None), out


class _Stop(Exception):
    """Stops a mine at a chosen chunk (phase 13's kill)."""


def _allreduce_ms(dist, block, runs=20):
    """Host-clock time of one all-reduce of ``block`` (on the card, between
    synchronisations)."""
    import torch
    cuda = block.is_cuda
    dist.all_reduce(block)
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(runs):
        dist.all_reduce(block)
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / runs


def _mesh_rank(rank, world, store, payload_path, out_dir):
    """One of phase 13's two gloo ranks sharing the card: the main-path
    geometries on meshes (2, 1) and (1, 2), each rank counting its shard
    or target block with K1 on the card, the mine on each, then a chunked
    mine on (2, 1) stopped after chunk ``kill`` of its level."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.mining import ItemVocab, MiningCheckpoint
    from repro_torch.mining.distributed import (DistributedMiner,
                                                distributed_counts)
    from repro_torch.roofline import autotune

    autotune.set_active_table(None)
    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    vocab = ItemVocab(tuple(p["items"]))
    dev = torch.device("cuda")
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    out = {"rank": rank, "meshes": {}}
    try:
        for shape in ((2, 1), (1, 2)):
            mesh = make_host_mesh(*shape, device_type="cpu")
            # the second pass is timed: the first loads the kernels
            for _ in range(2):
                ops.KERNEL_LAUNCHES = 0
                per_launch = {}
                for label, m, want in zip(p["labels"], p["masks"],
                                          p["dense"]):
                    ms, got = _launch_ms(obs, lambda: distributed_counts(
                        p["ub"], m, p["uw"], mesh, device=dev))
                    if not np.array_equal(got, want):
                        raise AssertionError(f"rank {rank}, mesh {shape}, "
                                             f"{label}: != K1's dense counts")
                    per_launch[f"{label} K={m.shape[0]}"] = ms
            counted = ops.KERNEL_LAUNCHES
            ops.KERNEL_LAUNCHES = 0
            got = DistributedMiner(mesh, device=dev).mine_frequent(
                p["ub"], p["uw"], vocab, p["min_count"], class_column=1)
            if got != p["want"]:
                raise AssertionError(f"rank {rank}, mesh {shape}: mine != "
                                     "the dense mine")
            k_pad = -(-max(m.shape[0] for m in p["masks"]) // shape[1]) \
                * shape[1]
            block = torch.zeros((k_pad, 2), dtype=torch.int32)
            out["meshes"][str(shape)] = dict(
                coord=mesh.get_coordinate(), kernel_ms=per_launch,
                count_launches=counted, mine_launches=ops.KERNEL_LAUNCHES,
                allreduce_ms=_allreduce_ms(dist, block),
                allreduce_bytes=block.numel() * 4)
        mesh = make_host_mesh(2, 1, device_type="cpu")

        def stop(level, j):
            if (level, j) == tuple(p["kill"]):
                raise _Stop()

        try:
            DistributedMiner(
                mesh, chunk_rows=p["chunk_rows"], device=dev,
                checkpoint=MiningCheckpoint(p["ckpt"])).mine_frequent(
                    p["ub"], p["uw"], vocab, p["min_count"], class_column=1,
                    on_chunk=stop)
            raise AssertionError(f"rank {rank}: the chunked mine did not "
                                 f"stop at {p['kill']}")
        except _Stop:
            out["stopped"] = list(p["kill"])
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _disk_tier(dev):
    """Phase 12: the disk tier at the spill threshold (see the module
    docstring).  Returns the launch counts and sweep numbers it read."""
    import math
    import os
    import shutil
    from itertools import combinations

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.kernels.itemset_count.ops import itemset_counts
    from repro_torch.mining import (DenseBackend, DenseDB, ItemVocab,
                                    backend_for_db, encode_targets,
                                    mine_frequent_backend)
    from repro_torch.mining.spill import (DEFAULT_SPILL_THRESHOLD_BYTES,
                                          SpilledBackend, SpilledDB,
                                          spilled_counts)
    from repro_torch.obs import counter_total
    from repro_torch.roofline import autotune, kernel_model

    autotune.set_active_table(None)
    n = SPILL_DB["n"]
    t = time.perf_counter()
    bits, w = _bernoulli_db(n, SPILL_DB["p_y"], SPILL_DB["seed"])
    footprint = bits.nbytes + w.nbytes
    print(f"   db: {n} rows x {SPILL_DB['items']} items (W=2, C=2, p_x 1/8, "
          f"p_y {SPILL_DB['p_y']}, not deduplicated), {int(w[:, 1].sum())} "
          f"rare-class rows, generated in {time.perf_counter() - t:.3f} s; "
          f"footprint {footprint} bytes against the spill threshold "
          f"{DEFAULT_SPILL_THRESHOLD_BYTES}")
    if footprint <= DEFAULT_SPILL_THRESHOLD_BYTES:
        raise AssertionError("the DB does not exceed the spill threshold")
    vocab = ItemVocab(tuple(range(SPILL_DB["items"])))
    t = time.perf_counter()
    ddb = DenseDB.from_arrays(vocab, bits, w, n_rows=n, n_classes=2,
                              device=dev)
    tx_d, w_d = ddb.bits, ddb.weights
    torch.cuda.synchronize()
    print(f"   resident DenseDB on the card in {time.perf_counter() - t:.3f} "
          f"s")
    spill_dir = ROOT / "build" / "spill"
    shutil.rmtree(spill_dir, ignore_errors=True)
    os.environ["REPRO_TORCH_SPILL_DIR"] = str(spill_dir)
    obs.configure(tracing=True)
    obs.TRACER.reset()
    out = {}
    sdb = None
    try:
        t = time.perf_counter()
        backend, choice = backend_for_db(
            ddb, spill_threshold_bytes=DEFAULT_SPILL_THRESHOLD_BYTES)
        t_choose = time.perf_counter() - t
        obs.configure(tracing=False)
        if choice.name != "spilled":
            raise AssertionError(f"the chooser picked {choice.name!r} for "
                                 f"{footprint} bytes, not 'spilled'")
        write = [sp for sp in obs.TRACER.spans() if sp.name == "spill.write"]
        write_s = write[-1].t1 - write[-1].t0
        print(f"   backend_for_db: {choice.name} ({choice.reason}); "
              f"{t_choose:.3f} s in all; the spill.write span "
              f"{write_s:.3f} s, {footprint / write_s / 1e9:.3f} GB/s "
              f"(segments fsync'd, the manifest last) into "
              f"{spill_dir.relative_to(ROOT)}")
        del backend
        sdb = SpilledDB.open(str(spill_dir), device=dev)
        spans = np.cumsum((0,) + sdb.seg_rows)
        spans = list(zip(spans[:-1].tolist(), spans[1:].tolist()))
        print(f"   SpilledDB.open: {sdb.n_chunks} segments of chunk_rows "
              f"{sdb.chunk_rows} (the last {sdb.seg_rows[-1]} rows), "
              f"{sdb.nbytes} bytes; untuned (autotune table: "
              f"{autotune.describe_active()})")

        items = list(vocab.items)
        geoms = [("singles", [(a,) for a in items]),
                 ("pairs", list(combinations(items, 2))),
                 ("triples", list(combinations(items, 3)))]
        trace_dir = ROOT / "build" / "traces"
        trace_dir.mkdir(parents=True, exist_ok=True)
        obs.configure(kernel_timing=False)
        sweeps = []
        pair_rows = {}
        for label, targets in geoms:
            masks = encode_targets(targets, vocab)
            k = masks.shape[0]
            tgt_d = torch.from_numpy(masks).to(dev)
            dense = itemset_counts(tx_d, tgt_d, w_d, accum="vpu_int32")
            # K3's bound: the segments' bounds, each with its contained
            # pairs (unit one-hot weights: a row adds 1 to one class)
            sizes = _target_sizes(tgt_d)
            bound = 0.0
            for s0, e0 in spans:
                hits = int(itemset_counts(tx_d[s0:e0], tgt_d, w_d[s0:e0],
                                          accum="vpu_int32").sum())
                bound += kernel_model.predicted_seconds(
                    e0 - s0, k, 2, 2, hits=hits, target_sizes=sizes) * 1e3
            walls = {True: [], False: []}
            ratio = read = None
            for _ in range(2):
                for prefetch in (True, False):
                    before = obs.snapshot()
                    t = time.perf_counter()
                    got = spilled_counts(sdb, masks, prefetch=prefetch)
                    torch.cuda.synchronize()
                    walls[prefetch].append((time.perf_counter() - t) * 1e3)
                    after = obs.snapshot()
                    if not torch.equal(got, dense):
                        raise AssertionError(f"spilled sweep (prefetch "
                                             f"{prefetch}) != K1's dense "
                                             f"pass at {label}")
                    read = (counter_total(after, "spill_bytes_read_total")
                            - counter_total(before, "spill_bytes_read_total"))
                    if prefetch:
                        hit = (counter_total(after, "spill_prefetch_hits_total")
                               - counter_total(before,
                                               "spill_prefetch_hits_total"))
                        ratio = hit / sdb.n_chunks
            if read != footprint:
                raise AssertionError(f"{label}: a sweep read {read} bytes, "
                                     f"the store holds {footprint}")
            trace = trace_dir / f"spill_{label}.json"
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                spilled_counts(sdb, masks, prefetch=True)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            kern, h2d = _device_intervals(trace)
            rec = dict(geometry=label, k=k, segments=sdb.n_chunks,
                       bytes_read=read, wall_ms_prefetch=walls[True],
                       wall_ms_sync=walls[False], hit_ratio=ratio,
                       k3_bound_ms=bound)
            best = min(walls[True])
            line = (f"   {label}: K={k}, {sdb.n_chunks} segments, {read} "
                    f"bytes read a sweep; wall ms prefetch on "
                    f"{' / '.join(f'{x:.1f}' for x in walls[True])}, off "
                    f"{' / '.join(f'{x:.1f}' for x in walls[False])} (two "
                    f"runs each, kernel timing off); read "
                    f"{read / best / 1e6:.3f} GB/s at the faster prefetch "
                    f"run; prefetch hit ratio {ratio:.3f}; K3 bound "
                    f"{bound:.4f} ms (the segments' sum)")
            if kern:
                ku, hu = _union(kern), _union(h2d)
                span = (max(e for _, e in ku + hu)
                        - min(s for s, _ in ku + hu))
                busy = _length(_union(kern + h2d))
                rec.update(kernels_ms=_length(ku) / 1e3,
                           h2d_ms=_length(hu) / 1e3, span_ms=span / 1e3,
                           idle=1 - busy / span)
                if rec["kernels_ms"] < bound:
                    raise AssertionError(f"{label}: the sweep's kernels took "
                                         f"{rec['kernels_ms']:.4f} ms, below "
                                         f"the K3 bound {bound:.4f} ms")
                line += (f"; profiled: device span {span / 1e3:.3f} ms, "
                         f"kernels {rec['kernels_ms']:.3f} ms, H2D copies "
                         f"{rec['h2d_ms']:.3f} ms ({len(h2d)}), device idle "
                         f"{rec['idle']:.1%} of the span")
            else:
                line += "; the profiler recorded no device events"
            print(line, flush=True)
            sweeps.append(rec)
            if label == "pairs":
                pair_rows = {pr: dense[targets.index(pr)].cpu().numpy()
                             for pr in SPILL_PAIRS}
                pair_masks, pair_dense = masks, dense
        # the numpy check of four pairs over all rows, independent of both
        t = time.perf_counter()
        want = _numpy_pair_counts(bits, w, SPILL_PAIRS)
        for pr, row in zip(SPILL_PAIRS, want):
            if not np.array_equal(pair_rows[pr], row):
                raise AssertionError(f"pair {pr}: K1 and the spilled sweeps "
                                     f"count {pair_rows[pr]}, numpy {row}")
        print(f"   numpy check, pairs {SPILL_PAIRS} over all {n} rows: "
              f"{want.tolist()} == K1's dense pass == every spilled sweep "
              f"({time.perf_counter() - t:.3f} s)")
        # the host copy alone: every segment from the mmap into a pinned
        # buffer on one thread, the page cache warm and then dropped
        pin = [torch.empty((sdb.chunk_rows, c), dtype=dt, pin_memory=True)
               for c, dt in ((2, torch.uint32), (2, torch.int32))]
        for cold in (False, True):
            if cold:
                _evict(sdb.directory)
            t = time.perf_counter()
            for j in range(sdb.n_chunks):
                for buf, a in zip(pin, sdb.segment(j)):
                    buf[:a.shape[0]].numpy()[...] = a
            ms = (time.perf_counter() - t) * 1e3
            sweeps[1][f"host_copy_ms_{'cold' if cold else 'warm'}"] = ms
            print(f"   the host copy alone, mmap -> pinned, all "
                  f"{sdb.n_chunks} segments on one thread"
                  f"{' after POSIX_FADV_DONTNEED' if cold else ''}: "
                  f"{ms:.1f} ms, {footprint / ms / 1e6:.3f} GB/s "
                  f"({ms / min(sweeps[1]['wall_ms_prefetch']):.2f} of the "
                  f"pair sweep's faster prefetch run)")
        del pin
        # the same sweep from the disk: the page cache dropped first
        for prefetch in (True, False):
            _evict(sdb.directory)
            t = time.perf_counter()
            got = spilled_counts(sdb, pair_masks, prefetch=prefetch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if not torch.equal(got, pair_dense):
                raise AssertionError("a sweep after the page cache was "
                                     "dropped != K1's dense pass")
            sweeps[1][f"cold_wall_ms_{'prefetch' if prefetch else 'sync'}"] \
                = ms
            print(f"   pairs after POSIX_FADV_DONTNEED on every segment: "
                  f"prefetch {'on' if prefetch else 'off'} {ms:.1f} ms, "
                  f"{footprint / ms / 1e6:.3f} GB/s")
        obs.configure(kernel_timing=True)

        # the mines: spilled (K3), dense, spilled under mxu_f32 (K3 by K2)
        min_count = math.ceil(0.01 * n)

        def mine(label, backend, **kw):
            ops.KERNEL_LAUNCHES = 0
            ops.KERNEL_LAUNCHES_INTO = 0
            for key in ops.KERNEL_LAUNCHES_BY_ACCUM:
                ops.KERNEL_LAUNCHES_BY_ACCUM[key] = 0
            t = time.perf_counter()
            freq = mine_frequent_backend(backend, min_count, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            counts = dict(all=ops.KERNEL_LAUNCHES,
                          into=ops.KERNEL_LAUNCHES_INTO,
                          **ops.KERNEL_LAUNCHES_BY_ACCUM)
            print(f"   {label} mine (min_count {min_count}): {len(freq)} "
                  f"itemsets, {sec:.3f} s, kernel launches {counts}",
                  flush=True)
            return freq, counts, sec

        spilled, sp_launch, sp_s = mine("SpilledBackend", SpilledBackend(sdb))
        dense_f, _, dense_s = mine("DenseBackend (level 1 through K1 too)",
                                   DenseBackend(ddb), level1_shortcut=False)
        lens = sorted({len(key) for key in spilled})
        if spilled != dense_f or len(spilled) != 60 + 1770 or lens != [1, 2]:
            raise AssertionError(f"spilled mine ({len(spilled)} itemsets of "
                                 f"sizes {lens}) != dense mine "
                                 f"({len(dense_f)}), or not the 60 singles "
                                 f"and 1,770 pairs")
        if sp_launch["into"] != 3 * sdb.n_chunks:
            raise AssertionError(f"spilled mine: {sp_launch['into']} K3 "
                                 f"launches, expected 3 levels x "
                                 f"{sdb.n_chunks} segments")
        kind = autotune.device_kind()
        pinned = {kernel_model.geometry_bucket(r, 1 << e, 2, 2): {
            "block_k": 128, "block_n": 512, "accum": "mxu_f32",
            "chunk_rows": 0, "us": 1.0}
            for r in set(sdb.seg_rows) for e in range(3, 21)}
        autotune.set_active_table(autotune.table_from_dict(
            {"schema": 1, "device_kind": kind, "entries": pinned},
            "<pinned>"))
        try:
            mxu, mxu_launch, _ = mine("SpilledBackend, table pinned to "
                                      "mxu_f32", SpilledBackend(sdb))
        finally:
            autotune.set_active_table(None)
        if mxu != dense_f or mxu_launch["mxu_f32"] != 3 * sdb.n_chunks \
                or mxu_launch["vpu_int32"] != 0:
            raise AssertionError(f"spilled mine under mxu_f32: launches "
                                 f"{mxu_launch}, or itemsets differ")
        print(f"   the three mines agree: 60 singles and 1,770 pairs, no "
              f"triple; spilled {sp_s:.3f} s, dense {dense_s:.3f} s")
        out.update(launches_spilled=sp_launch["into"],
                   launches_spilled_mxu=mxu_launch["mxu_f32"],
                   sweeps=sweeps, write_s=write_s, spilled_mine_s=sp_s,
                   dense_mine_s=dense_s)
    finally:
        obs.configure(tracing=False, kernel_timing=True)
        os.environ.pop("REPRO_TORCH_SPILL_DIR", None)
        if sdb is not None:
            sdb.delete()
        shutil.rmtree(spill_dir, ignore_errors=True)
    del ddb, tx_d, w_d
    torch.cuda.empty_cache()
    return out


def _mesh_runtime(dev, ub, uw, vocab, geoms, dense, want_freq, min_count):
    """Phase 13: the mesh runtime on the one card (see the module
    docstring).  Returns the launches per rank and the timings."""
    import datetime
    import pickle
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch import obs
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.mining import MiningCheckpoint
    from repro_torch.mining.distributed import (DistributedMiner,
                                                distributed_counts)
    from repro_torch.roofline import autotune

    autotune.set_active_table(None)
    mesh_dir = ROOT / "build" / "mesh"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    mesh_dir.mkdir(parents=True)
    labels = [label for label, _ in geoms]
    masks = [m for _, m in geoms]
    # level 2 less one target: K-blocks of unequal size on (1, 2)
    labels.append("level 2 less one")
    masks.append(masks[0][:-1])
    dense = list(dense) + [dense[0][:-1]]
    out = {"per_rank": {}}
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(mesh_dir / "nccl.store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        per_launch = {}
        for label, m, want in zip(labels, masks, dense):
            ms, got = _launch_ms(obs, lambda: distributed_counts(ub, m, uw,
                                                                 mesh))
            if not np.array_equal(got, want):
                raise AssertionError(f"(1, 1) NCCL mesh, {label}: != K1's "
                                     f"dense counts")
            per_launch[f"{label} K={m.shape[0]}"] = ms
        ops.KERNEL_LAUNCHES = 0
        t = time.perf_counter()
        got = DistributedMiner(mesh).mine_frequent(ub, uw, vocab, min_count,
                                                   class_column=1)
        mine_s = time.perf_counter() - t
        if got != want_freq:
            raise AssertionError("(1, 1) NCCL mesh: mine != the dense mine")
        # one launch a level on every rank: the frequent levels and the
        # next, whose candidates all fail
        levels = max(len(key) for key in want_freq) + 1
        if ops.KERNEL_LAUNCHES != levels:
            raise AssertionError(f"(1, 1) NCCL mine: {ops.KERNEL_LAUNCHES} "
                                 f"launches, expected {levels}")
        block = torch.zeros((masks[1].shape[0], 2), dtype=torch.int32,
                            device=dev)
        nccl_ms = _allreduce_ms(dist, block)
        out["per_rank"]["(1, 1) nccl"] = [ops.KERNEL_LAUNCHES]
        print(f"   (a) one rank, NCCL, mesh (1, 1): distributed_counts at "
              f"{len(masks)} geometries == K1's dense counts; per-launch "
              f"kernel ms {_fmt_ms(per_launch)}; DistributedMiner mine == "
              f"the dense mine ({len(got)} itemsets, "
              f"{ops.KERNEL_LAUNCHES} launches, {mine_s:.3f} s); "
              f"all-reduce of {block.numel() * 4} bytes {nccl_ms:.4f} ms",
              flush=True)

        # (b) two gloo ranks sharing the card
        ckpt = mesh_dir / "chunked.json"
        payload = mesh_dir / "payload.pkl"
        with open(payload, "wb") as f:
            pickle.dump(dict(ub=ub, uw=uw, items=list(vocab.items),
                             labels=labels, masks=masks, dense=dense,
                             want=want_freq, min_count=min_count,
                             chunk_rows=STREAM_CHUNK_ROWS, ckpt=str(ckpt),
                             kill=MESH_KILL), f)
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, daemon=True,
                             args=(r, 2, str(mesh_dir / "gloo.store"),
                                   str(payload), str(mesh_dir)))
                 for r in range(2)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_JOIN_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"two-rank gloo run: exit codes {codes}")
        ranks = [json.loads((mesh_dir / f"rank{r}.json").read_text())
                 for r in range(2)]
        print(f"   (b) two gloo ranks sharing the card, "
              f"{time.perf_counter() - t:.3f} s with the start-up: every "
              f"geometry on meshes (2, 1) and (1, 2) == K1's dense counts "
              f"on both ranks, each rank's mine == the dense mine")
        for shape in ("(2, 1)", "(1, 2)"):
            out["per_rank"][f"{shape} gloo"] = [
                rk["meshes"][shape]["mine_launches"] for rk in ranks]
            if out["per_rank"][f"{shape} gloo"] != [levels, levels]:
                raise AssertionError(f"mesh {shape} mine: launches per rank "
                                     f"{out['per_rank'][f'{shape} gloo']}, "
                                     f"expected {levels} each")
            for rk in ranks:
                me = rk["meshes"][shape]
                print(f"     mesh {shape}, rank {rk['rank']} at "
                      f"{tuple(me['coord'])}: per-launch kernel ms "
                      f"{_fmt_ms(me['kernel_ms'])}; mine "
                      f"{me['mine_launches']} launches; all-reduce of "
                      f"{me['allreduce_bytes']} bytes (host copy) "
                      f"{me['allreduce_ms']:.4f} ms")
        state = MiningCheckpoint(str(ckpt)).load_state()
        part = state["partial"]
        if (part["level"], part["next_chunk"]) != (MESH_KILL[0],
                                                   MESH_KILL[1] + 1):
            raise AssertionError(f"checkpoint after the stop: {part['level']}"
                                 f", next chunk {part['next_chunk']}")
        resumed = []
        t = time.perf_counter()
        got = DistributedMiner(
            mesh, chunk_rows=STREAM_CHUNK_ROWS,
            checkpoint=MiningCheckpoint(str(ckpt))).mine_frequent(
                ub, uw, vocab, min_count, class_column=1,
                on_chunk=lambda level, j: resumed.append((level, j)))
        if got != want_freq or resumed[0] != (MESH_KILL[0], MESH_KILL[1] + 1):
            raise AssertionError(f"resume on (1, 1): first chunk "
                                 f"{resumed[:1]}, or mine != the dense mine")
        print(f"   chunked mine (chunk_rows {STREAM_CHUNK_ROWS}) on (2, 1) "
              f"stopped after chunk {MESH_KILL[1]} of level {MESH_KILL[0]}; "
              f"rank 0's checkpoint resumed on the (1, 1) NCCL mesh at "
              f"{resumed[0]}, {time.perf_counter() - t:.3f} s: == the "
              f"uninterrupted mine")
        out.update(nccl_allreduce_ms=nccl_ms, nccl_kernel_ms=per_launch,
                   ranks=ranks)
    finally:
        dist.destroy_process_group()
    return out


def _bernoulli_rows(n, seed, n_items=60, p_x=0.125, p_y=0.01):
    """``data.bernoulli_db(n, n_items, p_x, p_y, seed)``'s rows again, from
    the same draws of the same generator: the (n, n_items) item matrix and
    the classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mat = rng.random((n, n_items)) < p_x
    return mat, (rng.random(n) < p_y).astype(np.int64)


def _pack(mat, y, vocab):
    """Rows of an item matrix packed in numpy under ``vocab``'s columns,
    with one-hot class weights, not deduplicated: a fresh encoding that
    shares no code with the port's."""
    import numpy as np
    bits = np.zeros((mat.shape[0], vocab.n_words), np.uint32)
    for c, item in enumerate(vocab.items):
        if item < mat.shape[1]:
            bits[:, c >> 5] |= mat[:, item].astype(np.uint32) << np.uint32(
                c & 31)
    w = np.zeros((mat.shape[0], 2), np.int32)
    w[np.arange(mat.shape[0]), y] = 1
    return bits, w


def _plain_counts(dev, parts, masks):
    """The plain version on the card over freshly packed rows (a list of
    ``(bits, weights)`` parts, padded to the masks' width): (K, C) int64."""
    import numpy as np
    import torch

    from repro_torch.kernels.itemset_count.ops import itemset_counts
    tgt = torch.from_numpy(np.ascontiguousarray(masks)).to(dev)
    out = np.zeros((masks.shape[0], 2), np.int64)
    for bits, w in parts:
        wide = np.zeros((bits.shape[0], masks.shape[1]), np.uint32)
        wide[:, :bits.shape[1]] = bits
        out += itemset_counts(torch.from_numpy(wide).to(dev), tgt,
                              torch.from_numpy(w).to(dev),
                              use_kernel=False).cpu().numpy()
    return out


def _quantiles(ms):
    from repro_torch.obs import nearest_rank
    s = sorted(ms)
    return nearest_rank(s, 0.5), nearest_rank(s, 0.99), s[-1]


def _flush_trace(trace_path, n_flushes, wall_ms):
    """A ``torch.profiler`` trace of ``n_flushes`` flushes taking
    ``wall_ms`` in all: per flush, the layout pass, the count kernel, the
    other device work (copies, fills), and the shares of the wall in which
    the device was busy and of the device's span in which it was idle."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    dev_spans, layout, count, other = [], 0.0, 0.0, 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        s, d = float(e["ts"]), float(e["dur"])
        dev_spans.append((s, s + d))
        name = e.get("name", "")
        if e.get("cat") == "kernel" and "layout_kernel" in name:
            layout += d
        elif e.get("cat") == "kernel" and "count_kernel" in name:
            count += d
        else:
            other += d
    if not dev_spans:
        return None
    busy = _length(_union(dev_spans)) / 1e3
    span = (max(e for _, e in dev_spans) - min(s for s, _ in dev_spans)) / 1e3
    return dict(layout_ms=layout / 1e3 / n_flushes,
                count_ms=count / 1e3 / n_flushes,
                other_ms=other / 1e3 / n_flushes,
                wall_ms=wall_ms / n_flushes,
                host_share=1 - busy / wall_ms,
                idle_share=1 - busy / span)


def _serve_rank(rank, world, store, payload_path, out_dir):
    """One of phase 14's two gloo ranks sharing the card: the same
    ``ShardedDB`` on mesh (2, 1) as the other rank, the same appends, each
    rank checking its own counts; its per-flush wall and all-reduce times,
    and the refusal of ``async_flush`` over two ranks."""
    import datetime
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.itemset_count import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline import autotune
    from repro_torch.serve import CountServer, ShardedDB

    autotune.set_active_table(None)
    with open(payload_path, "rb") as f:
        p = pickle.load(f)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(2, 1, device_type="cpu")
        t = time.perf_counter()
        sh = ShardedDB(p["tx"], classes=p["y"], n_classes=2, n_shards=2,
                       mesh=mesh, device=p["device"])
        out["build_s"] = time.perf_counter() - t
        ops.KERNEL_LAUNCHES = 0
        flush_ms = {}
        for step, (batch, yb) in enumerate(zip(p["batches"], p["batch_y"])):
            sh.append(batch, classes=yb)
            for label, keys in p["keys"].items():
                got = sh.counts(keys)         # places the rows: untimed
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    got = sh.counts(keys)
                    times.append((time.perf_counter() - t) * 1e3)
                if not np.array_equal(got, p["want"][step][label]):
                    raise AssertionError(f"rank {rank}, mesh (2, 1), after "
                                         f"append {step}, {label}: != the "
                                         "unsharded store")
                flush_ms[f"{label} after append {step}"] = \
                    statistics.median(times)
        out["flush_ms"] = flush_ms
        out["launches"] = ops.KERNEL_LAUNCHES
        out["rows_held"] = int(sh._mesh_resident[0].shape[0])
        k_pad = max(len(k) for k in p["keys"].values())
        block = torch.zeros((k_pad, 2), dtype=torch.int32)
        out["allreduce_ms"] = _allreduce_ms(dist, block)
        out["allreduce_bytes"] = block.numel() * 4
        try:
            CountServer(p["tx"][:100], classes=p["y"][:100], n_classes=2,
                        shards=2, mesh=mesh, async_flush=True)
            raise AssertionError("async_flush over two ranks was accepted")
        except ValueError as e:
            out["async_refused"] = str(e)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _count_server(dev, tx_rows, y, want_freq, k1_level3_ms):
    """Phase 14: the count server at the main path's 1,000,000 rows (see
    the module docstring).  Returns the launches by kernel."""
    import datetime
    import pickle
    import shutil
    import threading
    from itertools import combinations

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.core.incremental import ceil_count
    from repro_torch.data import bernoulli_db
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.kernels.itemset_count.ops import itemset_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.mining import encode_targets
    from repro_torch.roofline import autotune, kernel_model
    from repro_torch.serve import (CountCache, CountServer, ShardedDB,
                                   versioned_mine_frequent)

    autotune.set_active_table(None)
    for key in ops.KERNEL_LAUNCHES_BY_ACCUM:
        ops.KERNEL_LAUNCHES_BY_ACCUM[key] = 0
    ops.KERNEL_LAUNCHES_INTO = 0
    ops.KERNEL_LAUNCHES = 0
    launches = {}

    # ---- the store ----------------------------------------------------------
    t = time.perf_counter()
    srv = CountServer(tx_rows, classes=y, n_classes=2, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    st = srv.store
    bs = st.build_seconds
    print(f"   store: CountServer over {len(tx_rows)} rows in {build_s:.3f} "
          f"s (encode {bs['encode']:.3f} s, dedup {bs['dedup']:.3f} s, "
          f"residency choice + upload {bs['base']:.3f} s); resident "
          f"{st.resident} on {st.device}, base_rows {st.base_rows}, W "
          f"{st.vocab.n_words}, C 2; backend_choice "
          f"{st.backend_choice.name} ({st.backend_choice.reason}); serve "
          f"block_k {srv.batcher.block_k}", flush=True)
    if st.resident != "dense" or (len(tx_rows) == MAIN["n"]
                                  and st.base_rows != 969_130):
        raise AssertionError(f"store: {st.resident} base of {st.base_rows} "
                             "rows, expected dense and 969,130")
    vocab = st.vocab
    pairs = list(combinations(range(60), 2))
    triples = list(combinations(range(60), 3))
    pool = pairs + triples
    index = {key: i for i, key in enumerate(pool)}
    masks_all = encode_targets(pool, vocab)
    t = time.perf_counter()
    plain = itemset_counts(
        st.base.bits, torch.from_numpy(masks_all).to(dev), st.base.weights,
        use_kernel=False).cpu().numpy()
    print(f"   the plain version over the resident tensors: all "
          f"{len(pairs)} pairs and {len(triples)} triples in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    served = [0]

    def check(out, keys_by_ticket, label, want=None):
        for ticket, keys in keys_by_ticket.items():
            rows = out[ticket]
            ref = plain[[index[k] for k in keys]] if want is None else want
            if not np.array_equal(rows, ref):
                raise AssertionError(f"{label}: served counts != the plain "
                                     "version")
            served[0] += len(keys)

    def flush(keys, label, singles=True, want=None):
        """Submit ``keys`` (one request each, or one request of all) and
        flush; returns (wall ms, store launches, answered blocks).  The
        counts are held against ``plain`` (version 0), or against ``want``
        for one request of all."""
        tickets = ({srv.submit(f"c{i}", [k]): [k]
                    for i, k in enumerate(keys)} if singles
                   else {srv.submit("bulk", keys): list(keys)})
        n0 = st.kernel_launches
        t = time.perf_counter()
        out = srv.flush()
        ms = (time.perf_counter() - t) * 1e3
        check(out, tickets, label, want)
        return ms, st.kernel_launches - n0, out

    order = np.random.default_rng(14).permutation(len(pool))

    # ---- 1. per-flush latency by batch size, cold and warm ------------------
    lat = {}
    for b in (1, 4, 16, 64, 256):
        srv.cache = CountCache()
        flush([pool[i] for i in order[-b:]], f"warm-up b={b}")
        groups = [[pool[i] for i in order[j * b:(j + 1) * b]]
                  for j in range(20)]
        cold, warm = [], []
        for keys in groups:
            ms, n, _ = flush(keys, f"cold b={b}")
            if n != 1:
                raise AssertionError(f"cold flush of {b}: {n} launches, "
                                     "expected 1")
            cold.append(ms)
        for keys in groups:
            ms, n, _ = flush(keys, f"warm b={b}")
            if n != 0:
                raise AssertionError(f"warm flush of {b}: {n} launches")
            warm.append(ms)
        lat[b] = (_quantiles(cold), _quantiles(warm))
        (c50, c99, _), (w50, w99, _) = lat[b]
        print(f"   batch {b:>3}: cold median {c50:.3f} ms, p99 {c99:.3f} ms "
              f"(1 launch each); warm median {w50:.3f} ms, p99 {w99:.3f} ms "
              f"(cache hits, 0 launches); 20 flushes each", flush=True)

    # ---- 2. where a flush's time goes ---------------------------------------
    trace_dir = ROOT / "build" / "traces"
    trace_dir.mkdir(parents=True, exist_ok=True)
    split = {}
    nxt = 20 * 256
    for b in (1, 64):
        srv.cache = CountCache()
        groups = [[pool[i] for i in order[nxt + j * b:nxt + (j + 1) * b]]
                  for j in range(10)]
        nxt += 10 * b
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for keys in groups:
                flush(keys, f"profiled b={b}")
            wall = (time.perf_counter() - t) * 1e3
        path = trace_dir / f"serve_flush_b{b}.json"
        prof.export_chrome_trace(str(path))
        split[b] = _flush_trace(path, len(groups), wall)
        if split[b] is None:
            print(f"   batch {b}: the profiler recorded no device events: "
                  "the split is not measured")
            continue
        s = split[b]
        print(f"   batch {b:>2}, profiled (10 cold flushes): per flush "
              f"{s['wall_ms']:.3f} ms wall, layout pass {s['layout_ms']:.4f}"
              f" ms, count kernel {s['count_ms']:.4f} ms, other device work "
              f"{s['other_ms']:.4f} ms; layout pass "
              f"{s['layout_ms'] / (s['layout_ms'] + s['count_ms']):.1%} of "
              f"the kernels' time and {s['layout_ms'] / s['wall_ms']:.1%} of "
              f"the flush; host share (device not busy) "
              f"{s['host_share']:.1%} of the wall, device idle "
              f"{s['idle_share']:.1%} of its span", flush=True)

    # ---- 3. one flush of all 34,220 triples --------------------------------
    srv.cache = CountCache()
    ms3, n, _ = flush(triples, "all triples", singles=False)
    if n != 1:
        raise AssertionError(f"all-triples flush: {n} launches")
    print(f"   one flush of all {len(triples)} triples (one request): "
          f"{ms3:.3f} ms wall, 1 launch; phase 3's K1 at level 3 "
          f"{k1_level3_ms:.4f} ms", flush=True)

    # ---- 8. under the table pinned to mxu_f32 ------------------------------
    kind = autotune.device_kind()
    pinned = {kernel_model.geometry_bucket(st.base_rows, 1 << e,
                                           vocab.n_words, 2): {
        "block_k": 128, "block_n": 512, "accum": "mxu_f32", "chunk_rows": 0,
        "us": 1.0} for e in range(3, 21)}
    autotune.set_active_table(autotune.table_from_dict(
        {"schema": 1, "device_kind": kind, "entries": pinned}, "<pinned>"))
    mxu0 = ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"]
    srv.cache = CountCache()
    ms64, n64, _ = flush([pool[i] for i in order[:64]], "mxu_f32 b=64")
    msk, nk, _ = flush(triples, "mxu_f32 all triples", singles=False)
    grew = ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"] - mxu0
    autotune.set_active_table(None)
    if (n64, nk, grew) != (1, 1, 2):
        raise AssertionError(f"pinned mxu_f32 flushes: {n64} + {nk} launches,"
                             f" K2 launches grew by {grew}")
    print(f"   table pinned to mxu_f32: cold flush of 64 {ms64:.3f} ms, of "
          f"all {len(triples)} triples {msk:.3f} ms; K2 launches +{grew}; "
          f"exact", flush=True)
    print(f"   {served[0]} served counts == the plain version over the "
          f"resident tensors", flush=True)

    # ---- 6a. mining at version 0 -------------------------------------------
    t = time.perf_counter()
    got = srv.mine(1e-4, class_column=1, backend="store")
    t_store = time.perf_counter() - t
    if got != want_freq:
        raise AssertionError("mine(1e-4, class_column=1, backend='store') "
                             "!= phase 11's dense mine")
    t = time.perf_counter()
    got = srv.mine(1e-4, class_column=1, backend="auto")
    t_auto = time.perf_counter() - t
    verdict = srv.last_backend_choice
    if got != want_freq:
        raise AssertionError("mine(backend='auto') != phase 11's dense mine")
    print(f"   mine(1e-4, rare class): store {t_store:.3f} s, auto -> "
          f"{verdict.name} ({verdict.reason}) {t_auto:.3f} s; both == "
          f"phase 11's dense mine ({len(got)} itemsets)", flush=True)

    # ---- 4. appends and compaction -----------------------------------------
    tx_a, y_a = bernoulli_db(10_000, 60, 0.125, 0.01, seed=1)
    t = time.perf_counter()
    v = srv.append(tx_a, classes=y_a)
    t_append = time.perf_counter() - t
    delta = st.delta_rows
    if v != 1 or delta == 0:
        raise AssertionError(f"append: version {v}, delta {delta}")
    main_rows = _bernoulli_rows(len(tx_rows), 0)
    fresh = [_pack(*main_rows, vocab), _pack(*_bernoulli_rows(10_000, 1),
                                             vocab)]
    keys_a = [pool[i] for i in order[:512]]
    want_a = _plain_counts(dev, fresh, encode_targets(keys_a, vocab))
    ms_a, n, _ = flush(keys_a[:256], "after the append", singles=False,
                       want=want_a[:256])
    if n != 2:
        raise AssertionError(f"flush after the append: {n} launches "
                             "(expected 2), or != a fresh plain count of all "
                             f"{len(tx_rows) + 10_000} rows")
    t = time.perf_counter()
    st.base.bits.cpu()
    st.base.weights.cpu()
    d2h_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    st.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t
    _, n, _ = flush(keys_a[256:], "after compact()", singles=False,
                    want=want_a[256:])
    if n != 1 or st.delta_rows:
        raise AssertionError(f"flush after compact(): {n} launches")
    print(f"   append of 10,000 rows (seed 1): {t_append:.3f} s, version 1, "
          f"delta {delta} unique rows -> cold flush of 256 {ms_a:.3f} ms, 2 "
          f"launches (base + delta), == a fresh plain count of all "
          f"{len(tx_rows) + 10_000} rows; compact() inline {t_compact:.3f} "
          f"s (the base's D2H copy alone {d2h_ms:.3f} ms), base_rows "
          f"{st.base_rows}, then 1 launch a flush, exact", flush=True)

    # ---- 6b. incremental maintenance ---------------------------------------
    theta = 0.01
    t = time.perf_counter()
    srv.mine(theta, backend="store")
    t_mine = time.perf_counter() - t
    tx_b, y_b = bernoulli_db(10_000, 60, 0.125, 0.01, seed=2)
    t = time.perf_counter()
    srv.append(tx_b, classes=y_b)
    t_refresh = time.perf_counter() - t
    t = time.perf_counter()
    fresh_mine = versioned_mine_frequent(
        st, ceil_count(theta * st.n_rows))
    t_fresh = time.perf_counter() - t
    if srv.frequent != fresh_mine or not fresh_mine:
        raise AssertionError("frequent set after the incremental refresh != "
                             "a fresh mine of the whole history")
    print(f"   mine({theta}) of {st.n_rows - 10_000} rows {t_mine:.3f} s; "
          f"append of 10,000 rows (seed 2) with the incremental refresh "
          f"{t_refresh:.3f} s: frequent ({len(fresh_mine)} itemsets) == a "
          f"fresh mine of all {st.n_rows} rows ({t_fresh:.3f} s)",
          flush=True)
    del srv, st, plain, fresh
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 5. background compaction with async flush (200,000 rows) ----------
    n5 = 200_000
    tx5, y5 = tx_rows[:n5], y[:n5]
    t = time.perf_counter()
    asrv = CountServer(tx5, classes=y5, n_classes=2, device=dev,
                       background_compaction=True, async_flush=True,
                       max_delay_ms=5, min_batch=8, merge_ratio=0.005)
    print(f"   async server over {len(tx5)} rows (background compaction, "
          f"max_delay_ms 5, min_batch 8, merge_ratio 0.005): built in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    avocab = asrv.store.vocab
    batches = [bernoulli_db(2_000, 60, 0.125, 0.01, seed=100 + i)
               for i in range(8)]
    keys5 = [pool[i] for i in order[:1024]]
    futs = []
    lock = threading.Lock()

    def client(c):
        for key in keys5[c * 256:(c + 1) * 256]:
            v0 = asrv.store.version
            fut = asrv.submit_async(f"client{c}", [key])
            with lock:
                futs.append((key, v0, fut))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for tx_i, y_i in batches:
        asrv.append(tx_i, classes=y_i)
    for th in threads:
        th.join(120)
    asrv.close()                   # drains the flusher and the compactor
    t5 = time.perf_counter() - t
    # the exact counts of every key at every version 0..8
    m5 = encode_targets(keys5, avocab)
    head = (main_rows[0][:n5], main_rows[1][:n5])
    at_version = [_plain_counts(dev, [_pack(*head, avocab)], m5)]
    for i in range(8):
        at_version.append(at_version[-1] + _plain_counts(
            dev, [_pack(*_bernoulli_rows(2_000, 100 + i), avocab)], m5))
    row = {key: i for i, key in enumerate(keys5)}
    for key, v0, fut in futs:
        got = fut.result(timeout=1)[0]
        if not any(np.array_equal(got, at_version[v][row[key]])
                   for v in range(v0, 9)):
            raise AssertionError(f"async future for {key}: {got} is the "
                                 "count at no version from its submit on")
    ast = asrv.stats()
    p50, p99, pmax = _quantiles(list(asrv._flusher.latencies_ms))
    print(f"   4 client threads x 256 single queries while 8 appends of "
          f"2,000 rows landed, {t5:.3f} s: all {len(futs)} futures exact at "
          f"a version between their submit and the last append; "
          f"{ast['async']['flushes']} flushes (by trigger "
          f"{ast['async']['by_trigger']}), flush latency (queue wait of the "
          f"oldest request) p50 {p50:.3f} ms, p99 {p99:.3f} ms, max "
          f"{pmax:.3f} ms; {ast['store']['compactions']} background "
          f"compactions, version {ast['store']['version']}", flush=True)
    del asrv

    # ---- 7. the other residencies (200,000 rows) ---------------------------
    tx_d7, y_d7 = bernoulli_db(2_000, 60, 0.125, 0.01, seed=200)
    spill_dir = ROOT / "build" / "spill_serve"
    shutil.rmtree(spill_dir, ignore_errors=True)
    for label, kw in (("streaming", {}),
                      ("spilled", dict(spill_dir=str(spill_dir),
                                       spill_threshold_bytes=0))):
        t = time.perf_counter()
        s7 = CountServer(tx5, classes=y5, n_classes=2, device=dev,
                         chunk_rows=STREAM_CHUNK_ROWS, merge_ratio=1e9, **kw)
        build7 = time.perf_counter() - t
        s7.append(tx_d7, classes=y_d7)
        if s7.store.resident != label:
            raise AssertionError(f"{label} store is {s7.store.resident}")
        v7 = s7.store.vocab
        fresh7 = [_pack(*head, v7), _pack(*_bernoulli_rows(2_000, 200), v7)]
        chunks = s7.store.base.n_chunks
        for name, keys, singles in (("batch 64", keys5[:64], True),
                                    (f"K = {len(pairs)}", pairs, False)):
            want7 = _plain_counts(dev, fresh7, encode_targets(keys, v7))
            n0, i0 = s7.store.kernel_launches, ops.KERNEL_LAUNCHES_INTO
            tickets = ({s7.submit(f"c{i}", [k]): i
                        for i, k in enumerate(keys)} if singles
                       else {s7.submit("bulk", keys): None})
            t = time.perf_counter()
            out = s7.flush()
            ms7 = (time.perf_counter() - t) * 1e3
            n, into = s7.store.kernel_launches - n0, \
                ops.KERNEL_LAUNCHES_INTO - i0
            got = (np.concatenate([out[tk] for tk in tickets]) if singles
                   else out[next(iter(tickets))])
            if n != chunks + 1 or into != chunks or \
                    not np.array_equal(got, want7):
                raise AssertionError(f"{label} {name}: {n} launches ({into} "
                                     f"K3), expected {chunks} + 1, or != a "
                                     "fresh plain count")
            print(f"   {label} base ({chunks} chunks of {STREAM_CHUNK_ROWS}, "
                  f"built in {build7:.3f} s) + a 2,000-row delta: cold flush "
                  f"at {name} {ms7:.3f} ms, {n} launches ({into} K3 + 1 "
                  f"delta), exact", flush=True)
        if label == "streaming":
            unsharded = s7         # phase (9)'s reference
    shutil.rmtree(spill_dir, ignore_errors=True)

    # ---- 9. the mesh --------------------------------------------------------
    mesh_dir = ROOT / "build" / "mesh_serve"
    shutil.rmtree(mesh_dir, ignore_errors=True)
    mesh_dir.mkdir(parents=True)
    rng9 = np.random.default_rng(9)
    widen = [sorted(set(rng9.choice(100, size=8, replace=False).tolist()))
             for _ in range(1_000)]               # items up to 99: W 2 -> 4
    widen_y = (rng9.random(1_000) < 0.01).astype(int).tolist()
    mesh_keys = {"batch 64": keys5[:64],
                 f"K = {len(pairs)}": pairs,
                 "new items": [(60,), (0, 61), (99,), (3, 70, 98)]}
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(mesh_dir / "nccl.store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    try:
        mesh = make_host_mesh(1, 1, device_type="cuda")
        t = time.perf_counter()
        sh = ShardedDB(tx5, classes=y5, n_classes=2, n_shards=2, mesh=mesh,
                       device=dev)
        build9 = time.perf_counter() - t
        want_mesh = []
        flush_ms = {}
        for step, (batch, yb) in enumerate(((tx_d7, y_d7),
                                            (widen, widen_y))):
            sh.append(batch, classes=yb)
            if step == 1:
                unsharded.append(batch, classes=yb)
            want_mesh.append({})
            for label, keys in mesh_keys.items():
                want = unsharded.store.counts(keys)
                got = sh.counts(keys)
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    got = sh.counts(keys)
                    times.append((time.perf_counter() - t) * 1e3)
                if not np.array_equal(got, want):
                    raise AssertionError(f"(1, 1) NCCL ShardedDB, after "
                                         f"append {step}, {label}: != the "
                                         "unsharded store")
                want_mesh[-1][label] = want
                flush_ms[f"{label} after append {step}"] = \
                    statistics.median(times)
        if sh.vocab.n_words != 4 or sh.stats()["mesh"] != {"data": 1}:
            raise AssertionError(f"(1, 1) mesh: W {sh.vocab.n_words}, stats "
                                 f"{sh.stats()['mesh']}")
        block = torch.zeros((len(pairs), 2), dtype=torch.int32, device=dev)
        nccl_ms = _allreduce_ms(dist, block)
        print(f"   (a) one NCCL rank, mesh (1, 1): ShardedDB(n_shards=2) "
              f"over {len(tx5)} rows built in {build9:.3f} s == the unsharded "
              f"store before and after an append that widens W to 4; "
              f"per-flush wall ms (median of 5) {_fmt_ms(flush_ms)}; "
              f"all-reduce of {block.numel() * 4} bytes {nccl_ms:.4f} ms",
              flush=True)
    finally:
        dist.destroy_process_group()
    payload = mesh_dir / "payload.pkl"
    with open(payload, "wb") as f:
        pickle.dump(dict(tx=tx5, y=list(map(int, y5)),
                         batches=[tx_d7, widen],
                         batch_y=[list(map(int, y_d7)), widen_y],
                         keys=mesh_keys, want=want_mesh, device=str(dev)),
                    f)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_serve_rank, daemon=True,
                         args=(r, 2, str(mesh_dir / "gloo.store"),
                               str(payload), str(mesh_dir)))
             for r in range(2)]
    t = time.perf_counter()
    for q in procs:
        q.start()
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        for q in procs:
            q.join(max(0.0, deadline - time.monotonic()))
    finally:
        for q in procs:
            if q.is_alive():
                q.kill()
                q.join(10)
    codes = [q.exitcode for q in procs]
    if codes != [0, 0]:
        raise AssertionError(f"two-rank gloo serving run: exit codes {codes}")
    ranks = [json.loads((mesh_dir / f"rank{r}.json").read_text())
             for r in range(2)]
    print(f"   (b) two gloo ranks sharing the card, mesh (2, 1), "
          f"{time.perf_counter() - t:.3f} s with the start-up: each rank's "
          f"ShardedDB == the unsharded store after both appends; "
          f"async_flush refused on both")
    for rk in ranks:
        print(f"     rank {rk['rank']}: holds {rk['rows_held']} rows, built "
              f"in {rk['build_s']:.3f} s, {rk['launches']} launches; "
              f"per-flush wall ms {_fmt_ms(rk['flush_ms'])}; all-reduce of "
              f"{rk['allreduce_bytes']} bytes (host copy) "
              f"{rk['allreduce_ms']:.4f} ms", flush=True)
    launches.update(
        k1=ops.KERNEL_LAUNCHES_BY_ACCUM["vpu_int32"] - ops.KERNEL_LAUNCHES_INTO,
        k2=ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"],
        k3=ops.KERNEL_LAUNCHES_INTO,
        per_rank=[rk["launches"] for rk in ranks])
    return launches


# Phase 15's launcher runs: (label, extra arguments, runs into one
# directory one after the other).  Every run adds the common arguments.
LAUNCH_ROWS = 200_000
LAUNCH_VARIANTS = (
    ("(a) rules", ["--rules", "--theta", "0.001", "--min-conf", "0.01",
                   "--appends", "2", "--append-rows", "2000"], 1),
    ("(b) shards + async", ["--shards", "2", "--async-flush",
                            "--max-delay-ms", "25", "--theta", "0.001"], 1),
    ("(c) spill + bg compaction", ["--spill-dir", "build/spill_launch",
                                   "--spill-threshold-bytes", "4096",
                                   "--bg-compact", "--min-compact-rows",
                                   "64", "--theta", "0.001"], 2),
    ("(d) mesh (1, 1), NCCL", ["--shards", "2", "--mesh-data", "1"], 1),
)


def _launch_runs(dev, rows):
    """Phase 15 (4): the ``serve_counts`` launcher as subprocesses, the
    variants side by side (the runs of one variant one after the other, so
    that the second spills beside the first's store).  Returns per run its
    label, wall seconds, store launches and the wrapper's launch counters
    parsed from its output."""
    import shutil

    out_dir = ROOT / "build" / "serve_counts"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "spill_launch", ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    common = ["--rows", str(rows), "--items", "60", "--p-x", "0.125",
              "--p-y", "0.01", "--verify", "--device", dev.type]

    def start(i, label, extra, rep):
        args = list(extra)
        if label.startswith("(a)"):
            args += ["--metrics-dump", "build/serve_counts/metrics.json",
                     "--trace", "build/serve_counts/trace.json"]
        log = out_dir / f"run{i}_{rep}.log"
        f = open(log, "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_counts"]
            + common + args, cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT, text=True)
        return dict(label=label, rep=rep, log=log, proc=p, file=f,
                    t0=time.perf_counter(), args=args)

    pending = {i: list(range(reps)) for i, (_, _, reps) in
               enumerate(LAUNCH_VARIANTS)}
    running = {i: start(i, LAUNCH_VARIANTS[i][0], LAUNCH_VARIANTS[i][1],
                        pending[i].pop(0)) for i in pending}
    done = []
    deadline = time.monotonic() + 600
    try:
        while running:
            if time.monotonic() > deadline:
                raise AssertionError("serve_counts runs still going after "
                                     "600 s")
            for i, r in list(running.items()):
                if r["proc"].poll() is None:
                    continue
                r["wall_s"] = time.perf_counter() - r["t0"]
                r["file"].close()
                done.append(r)
                del running[i]
                if pending[i]:
                    running[i] = start(i, *LAUNCH_VARIANTS[i][:2],
                                       pending[i].pop(0))
            time.sleep(0.05)
    finally:
        for r in running.values():
            r["proc"].kill()
            r["proc"].wait()
            r["file"].close()
    results = []
    for r in sorted(done, key=lambda r: (r["label"], r["rep"])):
        text = r["log"].read_text()
        if r["proc"].returncode != 0:
            raise AssertionError(f"serve_counts {r['label']} run {r['rep']}"
                                 f" exited {r['proc'].returncode}:\n"
                                 f"{text[-3000:]}")
        if not re.search(r"verified \d+ keys bit-identical", text):
            raise AssertionError(f"serve_counts {r['label']}: no verified "
                                 "line")
        if "--rules" in r["args"] and \
                "== host minority_report oracle" not in text:
            raise AssertionError(f"serve_counts {r['label']}: no host "
                                 "minority_report oracle line")
        m = re.search(r"kernel launches by route: (\d+) \(vpu_int32 (\d+), "
                      r"mxu_f32 (\d+); accumulate-into (\d+)\)", text)
        store = re.search(r"; (\d+) kernel launches\n", text)
        if m is None or store is None:
            raise AssertionError(f"serve_counts {r['label']}: no launch "
                                 "lines")
        launches, vpu, mxu, into = (int(g) for g in m.groups())
        if dev.type == "cuda" and vpu == 0:
            raise AssertionError(f"serve_counts {r['label']}: no K1 launch")
        results.append(dict(
            label=r["label"], rep=r["rep"], wall_s=r["wall_s"],
            store_launches=int(store.group(1)), launches=launches,
            k1=vpu - into, k2=mxu, k3=into,
            lines=[ln for ln in text.splitlines()
                   if ln.startswith(("verified", "resident", "mined",
                                     "top_rules", "served", "async:",
                                     "rules:", "append"))]))
    return results


def _rule_server(dev, tx_rows, y, main_rules, launch_rows=LAUNCH_ROWS):
    """Phase 15: the rule server at the main path's 1,000,000 rows, the
    exporter, the lock watcher and the ``serve_counts`` launcher (see the
    module docstring).  Returns the launches by path."""
    import threading
    import urllib.request
    from dataclasses import astuple as _t
    from itertools import combinations

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import optimal_rule_set
    from repro_torch.data import bernoulli_db
    from repro_torch.kernels.itemset_count import ops
    from repro_torch.kernels.itemset_count.ops import itemset_counts
    from repro_torch.mining import encode_targets
    from repro_torch.obs.export import start_metrics_server
    from repro_torch.roofline import autotune
    from repro_torch.serve import (CountCache, CountServer, RuleCache,
                                   RuleServer, canonical_itemset)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    autotune.set_active_table(None)
    n_main = len(tx_rows)
    theta, min_conf = MAIN["min_support"], MAIN["min_conf"]
    t = time.perf_counter()
    srv = CountServer(tx_rows, classes=y, n_classes=2, device=dev)
    sync()
    st = srv.store
    print(f"   (1) CountServer over {n_main} rows built in "
          f"{time.perf_counter() - t:.3f} s: {st.resident}, base_rows "
          f"{st.base_rows}, backend_choice {st.backend_choice.name}; "
          f"RuleServer(target_class=1, prefetch_top 8)", flush=True)
    ruler = RuleServer(srv)
    metrics = start_metrics_server(0)

    # the rule server's path, its counts set to 0 just before it
    for key in ops.KERNEL_LAUNCHES_BY_ACCUM:
        ops.KERNEL_LAUNCHES_BY_ACCUM[key] = 0
    ops.KERNEL_LAUNCHES_INTO = 0
    ops.KERNEL_LAUNCHES = 0

    # ---- (1) top_rules at the main path's theta and min_conf ---------------
    t = time.perf_counter()
    top = ruler.top_rules(theta, min_conf)
    t_top = time.perf_counter() - t
    verdict = srv.last_backend_choice
    tr = verdict.traits
    if [_t(r) for r in top] != [_t(r) for r in main_rules]:
        raise AssertionError("top_rules != phase 5's rules")
    t = time.perf_counter()
    opt = ruler.top_rules(theta, min_conf, optimal=True)
    t_opt = time.perf_counter() - t
    if [_t(r) for r in opt] != [_t(r) for r in optimal_rule_set(main_rules)]:
        raise AssertionError("top_rules(optimal=True) != optimal_rule_set "
                             "of phase 5's rules")
    if verdict.name != "dense":
        raise AssertionError(f"the chooser picked {verdict.name} for "
                             "top_rules' mine, expected dense")
    print(f"   top_rules({theta}, {min_conf}): {len(top)} rules == phase 5's"
          f", in order, {t_top:.3f} s; the mine's chooser verdict "
          f"{verdict.name} ({verdict.reason}; density {tr.density:.4f}, "
          f"skew {tr.skew:.3f}x); optimal=True {len(opt)} rules == "
          f"optimal_rule_set of phase 5's, {t_opt:.3f} s", flush=True)

    # every pair and triple at min_conf against the plain version's counts
    pool = list(combinations(range(60), 2)) + list(combinations(range(60),
                                                                3))
    masks = encode_targets(pool, st.vocab)
    plain = itemset_counts(st.base.bits, torch.from_numpy(masks).to(dev),
                           st.base.weights, use_kernel=False).cpu().numpy()

    def expect(rows, keys, n_db, mc):
        out = []
        for key, row in zip(keys, rows):
            cnt, gcnt = int(row[1]), int(row[0])
            conf = cnt / (cnt + gcnt) if (cnt + gcnt) else 0.0
            out.append(None if conf < mc else (
                canonical_itemset(key), 1, cnt / n_db, conf, cnt, gcnt))
        return out

    def as_t(rules):
        return [None if r is None else _t(r) for r in rules]

    n0 = st.kernel_launches
    t = time.perf_counter()
    got = ruler.rules_for(pool, min_conf=min_conf)
    t_all = time.perf_counter() - t
    want_all = expect(plain, pool, n_main, min_conf)
    if as_t(got) != want_all:
        raise AssertionError("rules_for over all pairs and triples != rules "
                             "from the plain version's counts")
    print(f"   rules_for all {len(pool)} pairs and triples at min_conf "
          f"{min_conf}: {sum(r is not None for r in got)} rules == the plain "
          f"version's, {t_all * 1e3:.3f} ms, {st.kernel_launches - n0} "
          f"launch", flush=True)

    # per-call latency, cold (fresh caches: one launch a call) and warm
    index = {key: i for i, key in enumerate(pool)}
    order = np.random.default_rng(15).permutation(len(pool))
    lat = {}
    nxt = 0
    for b in (1, 64, 256):
        ruler.cache = RuleCache()
        srv.cache = CountCache()
        groups = [[pool[i] for i in order[nxt + j * b:nxt + (j + 1) * b]]
                  for j in range(20)]
        nxt += 20 * b
        cold, warm = [], []
        for phase, times in (("cold", cold), ("warm", warm)):
            for keys in groups:
                n0 = st.kernel_launches
                t = time.perf_counter()
                got = ruler.rules_for(keys, min_conf=min_conf)
                times.append((time.perf_counter() - t) * 1e3)
                n = st.kernel_launches - n0
                if n != (1 if phase == "cold" else 0):
                    raise AssertionError(f"{phase} rules_for of {b}: {n} "
                                         "launches")
                if as_t(got) != [want_all[index[k]] for k in keys]:
                    raise AssertionError(f"{phase} rules_for of {b} != the "
                                         "plain version's")
        lat[b] = (_quantiles(cold), _quantiles(warm))
        (c50, c99, _), (w50, w99, _) = lat[b]
        print(f"   rules_for batch {b:>3}: cold median {c50:.3f} ms, p99 "
              f"{c99:.3f} ms (1 launch each); warm median {w50:.3f} ms, p99 "
              f"{w99:.3f} ms (rule-cache hits, 0 launches); 20 calls each",
              flush=True)
    rc = ruler.stats()["rule_cache"]
    print(f"   rule cache over the latency runs: hit rate "
          f"{rc['hit_rate']:.4f} ({rc['hits']} hits, {rc['misses']} misses)",
          flush=True)

    # count traffic beside the rules: five flushes for the exporter
    for i in range(5):
        srv.submit(f"c{i}", [pool[order[-1 - i]]])
        srv.flush()

    # ---- (1) an append through the rule server, then the prefetched keys ---
    tx_a, y_a = bernoulli_db(10_000, 60, 0.125, 0.01, seed=1)
    hottest = [k for (k, tc, mc), _ in sorted(
        ruler._heat.items(), key=lambda kv: (-kv[1], repr(kv[0])))[:8]]
    t = time.perf_counter()
    v = ruler.append(tx_a, classes=y_a)
    t_app = time.perf_counter() - t
    main_rows = _bernoulli_rows(n_main, 0)
    fresh = [_pack(*main_rows, st.vocab), _pack(*_bernoulli_rows(10_000, 1),
                                                st.vocab)]
    want_hot = expect(_plain_counts(dev, fresh,
                                    encode_targets(hottest, st.vocab)),
                      hottest, st.n_rows, min_conf)
    n0, h0 = st.kernel_launches, ruler.cache.hits
    got = ruler.rules_for(hottest, min_conf=min_conf)
    if st.kernel_launches != n0 or ruler.cache.hits != h0 + len(hottest):
        raise AssertionError("the prefetched hottest keys were not answered "
                             "from the rule cache")
    if v != 1 or as_t(got) != want_hot:
        raise AssertionError("prefetched rules after the append != rules "
                             "from a fresh plain count of all rows")
    print(f"   append of 10,000 rows (seed 1) through the rule server "
          f"{t_app:.3f} s, version {v}, {ruler.n_prefetched_keys} hottest "
          f"keys re-warmed: answered from the rule cache (0 launches) == "
          f"rules from a fresh plain count of all {st.n_rows} rows",
          flush=True)

    # ---- (2) the exporter ---------------------------------------------------
    try:
        port = metrics.server_address[1]
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=30).read().decode()
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=30).read())
    finally:
        metrics.shutdown()
    m = re.search(r"^serve_flush_ms_count (\d+)$", text, re.M)
    want_n = snap["histograms"]["serve_flush_ms"][""]["count"]
    if m is None or int(m.group(1)) != want_n or want_n < 5:
        raise AssertionError(f"/metrics serve_flush_ms_count "
                             f"{m and m.group(1)} != the snapshot's {want_n}")
    print(f"   (2) /metrics ({len(text)} bytes, "
          f"{text.count('# TYPE')} metrics) and /metrics.json fetched: "
          f"serve_flush_ms_count {m.group(1)} == the snapshot's; server shut "
          f"down", flush=True)
    del srv, st, ruler, plain, fresh
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- (3) the lock watcher -----------------------------------------------
    n5 = 200_000
    tx5, y5 = tx_rows[:n5], y[:n5]
    asrv = CountServer(tx5, classes=y5, n_classes=2, device=dev,
                       background_compaction=True, async_flush=True,
                       max_delay_ms=5, min_batch=8, merge_ratio=0.005)
    aruler = RuleServer(asrv)
    watcher = obs.instrument_server(asrv, registry=obs.REGISTRY)
    avocab = asrv.store.vocab
    batches = [bernoulli_db(2_000, 60, 0.125, 0.01, seed=100 + i)
               for i in range(8)]
    keys5 = [pool[i] for i in order[:512]]
    seen = []
    lock = threading.Lock()

    def client(c):
        for key in keys5[c * 128:(c + 1) * 128]:
            v0 = asrv.store.version
            (rule,) = aruler.rules_for([key], min_conf=0.0)
            fut = asrv.submit_async(f"client{c}", [key])
            with lock:
                seen.append((key, v0, rule, fut))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    t = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for tx_i, y_i in batches:
            aruler.append(tx_i, classes=y_i)
        for th in threads:
            th.join(120)
        asrv.close()
    finally:
        while isinstance(obs.REGISTRY._lock, obs.WatchedLock):
            obs.REGISTRY._lock = obs.REGISTRY._lock._lock
    t3 = time.perf_counter() - t
    sync()
    # the rule server's path ends here (steps 1 and 3)
    launches = dict(
        k1=ops.KERNEL_LAUNCHES_BY_ACCUM["vpu_int32"] - ops.KERNEL_LAUNCHES_INTO,
        k2=ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"],
        k3=ops.KERNEL_LAUNCHES_INTO)
    if dev.type == "cuda" and launches["k1"] == 0:
        raise AssertionError("the rule server's path launched no K1")
    if any(th.is_alive() for th in threads):
        raise AssertionError("lock-watcher clients still running")
    m5 = encode_targets(keys5, avocab)
    head = (main_rows[0][:n5], main_rows[1][:n5])
    at_version = [_plain_counts(dev, [_pack(*head, avocab)], m5)]
    for i in range(8):
        at_version.append(at_version[-1] + _plain_counts(
            dev, [_pack(*_bernoulli_rows(2_000, 100 + i), avocab)], m5))
    row = {key: i for i, key in enumerate(keys5)}
    for key, v0, rule, fut in seen:
        got = fut.result(timeout=1)[0]
        want = [at_version[v][row[key]] for v in range(v0, 9)]
        if not any(np.array_equal(got, w) for w in want):
            raise AssertionError(f"async future for {key}: {got} is the "
                                 "count at no version from its submit on")
        if not any((rule.g_count, rule.count) == (int(w[0]), int(w[1]))
                   and rule.support == rule.count / (len(tx5) + 2_000 * v)
                   for v, w in zip(range(v0, 9), want)):
            raise AssertionError(f"rule verdict for {key} is exact at no "
                                 "version from its call on")
    edges = watcher.edges()
    need = [("CountServer._lock", "AsyncFlusher._lat_lock"),
            ("VersionedDB._store_lock", "AsyncCompactor._mu")]
    if watcher.cycles() or any(e not in edges for e in need):
        raise AssertionError(f"lock watcher: {watcher.report()}")
    ast = asrv.stats()
    print(f"   (3) instrumented async server over {len(tx5)} rows "
          f"(background "
          f"compaction): 4 threads x 128 rules_for + submit_async while 8 "
          f"appends of 2,000 rows went through the rule server, {t3:.3f} s; "
          f"all {len(seen)} verdicts and futures exact at a version between "
          f"their call and the last append; {ast['store']['compactions']} "
          f"background compactions; no lock-order cycle; edges:", flush=True)
    for (a, b), n in sorted(edges.items()):
        print(f"     {a} -> {b}: {n}")
    del asrv, aruler

    # ---- (4) the launcher ---------------------------------------------------
    runs = _launch_runs(dev, launch_rows)
    for r in runs:
        print(f"   (4) serve_counts {r['label']} run {r['rep'] + 1}: exit 0, "
              f"{r['wall_s']:.3f} s wall (variants side by side), "
              f"{r['store_launches']} store launches, K1 {r['k1']}, K2 "
              f"{r['k2']}, K3 {r['k3']}", flush=True)
        for ln in r["lines"]:
            print(f"       | {ln}")
    launches.update(
        launcher_k1=sum(r["k1"] for r in runs),
        launcher_k2=sum(r["k2"] for r in runs),
        launcher_k3=sum(r["k3"] for r in runs),
        rule_lat=lat, t_top=t_top, verdict=verdict.name)
    return launches


def _rel_rows(got, want, vocab):
    """(max over rows of |got - want|_2 / |want|_2, max |got - want|) over
    the real vocabulary, in float32."""
    g = got[..., :vocab].float()
    w = want[..., :vocab].float()
    rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
    return float(rel.max()), float((g - w).abs().max())


def _zoo_reduced(dev):
    """Phase 16 (a): every arch, reduced, float32, card against host."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model

    assert not torch.backends.cuda.matmul.allow_tf32
    errs = {}
    for arch in sorted(ARCHS):
        cpu = get_model(arch, reduced=True, device="cpu").init(
            torch.Generator().manual_seed(0))
        gpu = get_model(arch, reduced=True, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        cfg = cpu.cfg
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))
        frames = None
        if cfg.encdec:
            frames = torch.as_tensor(
                rng.normal(size=(2, 36, cfg.frontend_dim)), dtype=torch.float32)
        pairs = [("forward", gpu.forward(toks, frames=frames),
                  cpu.forward(toks, frames=frames))]
        lg, cg = gpu.prefill(toks[:, :32], 36, frames=frames)
        lc, cc = cpu.prefill(toks[:, :32], 36, frames=frames)
        pairs.append(("prefill", lg, lc))
        for i, (a, b) in enumerate(zip(cg["layers"], cc["layers"])):
            pairs += [(f"cache {i}.{k}", a[k], b[k]) for k in b]
        if cfg.encdec:
            pairs += [(f"cache {k} {i}", cg[k][i], cc[k][i])
                      for k in ("enc_k", "enc_v") for i in range(cfg.n_layers)]
        for step in range(4):
            pos = 32 + step
            lg, cg = gpu.decode_step(cg, toks[:, pos:pos + 1], pos)
            lc, cc = cpu.decode_step(cc, toks[:, pos:pos + 1], pos)
            pairs.append((f"decode {step}", lg, lc))
        err = 0.0
        for what, a, b in pairs:
            a = a.cpu()
            torch.testing.assert_close(a, b, rtol=ZOO_F32_TOL,
                                       atol=ZOO_F32_TOL,
                                       msg=lambda m: f"{arch} {what}: {m}")
            err = max(err, float((a - b).abs().max()))
        errs[arch] = err
        print(f"   (a) {arch:28s} reduced float32, card == host within "
              f"{ZOO_F32_TOL:g}: {len(pairs)} tensors, max |err| {err:.3e}",
              flush=True)
    return errs


def _f32_reference(model, prompts, o, tol, smi):
    """The bf16 launcher run against a float32 copy of its weights: bf16
    ``forward`` and bf16 prefill/decode, each against the float32
    ``forward`` over the same sequence (relative L2 per row); the first
    says how far bf16 alone moves the logits."""
    import torch

    from repro_torch.models import get_model

    cfg = model.cfg
    seq = torch.cat([prompts, o.tokens[:, :-1]], dim=1)
    ref = get_model(cfg.name, device=model.device, dtype="float32")
    ref.load_state_dict(model.state_dict())
    want = ref.forward(seq)[:, prompts.shape[1] - 1:]
    del ref
    fwd = model.forward(seq)[:, prompts.shape[1] - 1:]
    rel_fwd, _ = _rel_rows(fwd, want, cfg.vocab_size)
    rel_dec, mx = _rel_rows(o.logits, want, cfg.vocab_size)
    del want, fwd
    torch.cuda.empty_cache()
    if rel_dec > tol:
        raise AssertionError(f"{cfg.name}: bf16 prefill/decode differ from "
                             f"the float32 forward by {rel_dec:.4f} > {tol:.4f}")
    print(f"   against a float32 copy of the weights: bf16 forward max "
          f"relative L2 {rel_fwd:.4e}, bf16 prefill/decode {rel_dec:.4e} "
          f"(max |err| {mx:.4f}) [{smi}]", flush=True)
    return {"bf16_forward_rel": rel_fwd, "bf16_decode_rel": rel_dec}


def _decode_trace(model, prompts, steps, arch, smi):
    """A ``torch.profiler`` trace of ``steps`` decode steps after a prefill
    of ``prompts`` (one warm step first): kernels a step, device busy ms a
    step and the device's idle share of the traced span.  The profiler's
    own host cost is in the span, so the idle share is an upper bound."""
    import torch
    s = prompts.shape[1]
    _, cache = model.prefill(prompts, s + steps + 1)
    tok = prompts[:, -1:]
    model.decode_step(cache, tok, s)
    torch.cuda.synchronize()
    trace = ROOT / "build" / "traces" / f"decode_{arch}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            model.decode_step(cache, tok, s + 1 + i)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    kern, _ = _device_intervals(trace)
    if not kern:
        raise AssertionError(f"{arch}: the decode trace holds no kernel")
    busy = _length(_union(kern)) / 1e3
    span = (max(e for _, e in kern) - min(b for b, _ in kern)) / 1e3
    out = {"kernels_per_step": len(kern) / steps,
           "device_busy_ms_per_step": busy / steps,
           "traced_span_ms_per_step": span / steps,
           "idle_share": 1.0 - busy / span}
    print(f"   decode trace ({steps} steps, {trace.relative_to(ROOT)}): "
          f"{out['kernels_per_step']:.1f} kernels a step, device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms of "
          f"{out['traced_span_ms_per_step']:.3f} ms a step, idle share "
          f"{out['idle_share']:.3f} [{smi}]", flush=True)
    del cache
    return out


def _zoo_full(dev, smi, arch, argv, long_prompt):
    """Phase 16 (b) / (c): one arch at full width and depth in bf16 through
    the launcher twice, then (b) a long prefill; each checked against
    ``forward`` over the whole sequence."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    argv = ["--arch", arch, "--device", "cuda"] + argv
    print(f"   python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    run = serve.main(argv)
    model, cfg, out = run.model, run.model.cfg, run.out
    peak_launch = torch.cuda.max_memory_allocated()
    n_params = model.n_params()
    weights_b = sum(p.numel() * p.element_size() for p in model.parameters())
    if weights_b != n_params * 2 or model.dtype != torch.bfloat16:
        raise AssertionError(f"{arch}: {weights_b} bytes of weights for "
                             f"{n_params} bf16 parameters")
    b, s = run.prompts.shape
    gen = out.tokens.shape[1]
    tol = _bf16_tol(cfg.n_layers)

    def cache_bytes(batch, max_len):
        c = model.init_cache(batch, max_len)
        n = sum(t.numel() * t.element_size() for lc in c["layers"]
                for t in lc.values())
        del c
        return n

    def check(prompts, o, label):
        seq = torch.cat([prompts, o.tokens[:, :-1]], dim=1)
        full = model.forward(seq)
        got = o.logits
        want = full[:, prompts.shape[1] - 1:]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{arch} {label}: non-finite logits")
        rel, mx = _rel_rows(got, want, cfg.vocab_size)
        del full
        if rel > tol:
            raise AssertionError(f"{arch} {label}: prefill/decode logits "
                                 f"differ from forward by {rel:.4f} > "
                                 f"{tol:.4f} (relative L2)")
        agree = float((o.tokens == want[..., :cfg.vocab_size].argmax(-1))
                      .float().mean())
        print(f"   {label}: prefill + {o.tokens.shape[1] - 1} decode steps vs "
              f"forward over {seq.shape[1]} tokens: max relative L2 "
              f"{rel:.4e} (tol {tol:.4f}), max |err| {mx:.4f}, greedy "
              f"tokens equal to forward's argmax {agree:.3f}", flush=True)
        return rel, mx

    def timing(o, label, batch, prompt):
        steps = o.tokens.shape[1] - 1
        ms = o.decode_s * 1e3 / max(steps, 1)
        tok_s = batch * steps / max(o.decode_s, 1e-9)
        print(f"   {label}: prefill {batch}x{prompt} {o.prefill_s * 1e3:.3f}"
              f" ms, decode {ms:.3f} ms/step over {steps} steps "
              f"({tok_s:,.1f} tok/s) [{smi}]", flush=True)
        return {"prefill_ms": o.prefill_s * 1e3, "decode_ms_per_step": ms,
                "tok_s": tok_s}

    rec = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": n_params, "dtype": cfg.dtype, "tol_bf16_rel_l2": tol,
           "card": smi}
    launch = {"batch": b, "prompt": s, "gen": gen}
    launch.update(timing(out, "launcher run 1", b, s))
    launch["max_rel_err"], launch["max_abs_err"] = check(run.prompts, out,
                                                         "launcher run 1")
    cache_b = cache_bytes(b, s + gen)
    launch.update(peak_gib=peak_launch / 2**30, weights_gib=weights_b / 2**30,
                  cache_gib=cache_b / 2**30)
    print(f"   launcher run 1: peak allocated {peak_launch / 2**30:.3f} GiB; "
          f"weights {weights_b / 2**30:.3f} GiB (n_params {n_params:,} x 2 "
          f"bytes) + cache {cache_b / 2**30:.4f} GiB [{smi}]", flush=True)

    launch["float32"] = _f32_reference(model, run.prompts, out, tol, smi)
    launch["trace"] = _decode_trace(model, run.prompts, 8, arch, smi)

    # the same seed again: the same weights, prompts and greedy tokens
    run2 = serve.main(argv)
    if not torch.equal(run2.out.tokens, out.tokens):
        raise AssertionError(f"{arch}: two launcher runs from one seed gave "
                             "different tokens")
    launch["run2"] = timing(run2.out, "launcher run 2 (same tokens)", b, s)
    del run2
    torch.cuda.empty_cache()
    rec["launcher"] = launch

    if long_prompt:
        lp, lgen = long_prompt
        rng = np.random.default_rng(1)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, lp)),
                                  device=model.device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        o = serve.generate(model, prompts, lgen)
        peak = torch.cuda.max_memory_allocated()
        long = {"batch": b, "prompt": lp, "gen": lgen}
        long.update(timing(o, "long prompt", b, lp))
        cb = cache_bytes(b, lp + lgen)
        long.update(peak_gib=peak / 2**30, cache_gib=cb / 2**30,
                    max_len=lp + lgen)
        print(f"   long prompt: peak allocated {peak / 2**30:.3f} GiB (weights "
              f"and buffers before it {base / 2**30:.3f} GiB; cache "
              f"{b}x{lp + lgen} {cb / 2**30:.4f} GiB) [{smi}]",
              flush=True)
        long["max_rel_err"], long["max_abs_err"] = check(prompts, o,
                                                         "long prompt")
        rec["long"] = long
        del o
    rec["seconds"] = time.perf_counter() - t0
    del run, model, out
    torch.cuda.empty_cache()
    return rec


def _fmt_ms(d):
    return ", ".join(f"{key} {v:.4f}" if v is not None else f"{key} -"
                     for key, v in d.items())


def _model_zoo(dev, smi):
    """Phase 16: (a) the reduced archs, (b) qwen3-8b, (c) mamba2-2.7b."""
    reduced = _zoo_reduced(dev)
    # (b): the JAX launcher's defaults, then 4 x 2,048 into a 4 x 2,080 cache
    qwen = _zoo_full(dev, smi, "qwen3-8b", [], long_prompt=(2048, 32))
    # (c): 2 SSD chunks of 256, then 16 decode steps
    mamba = _zoo_full(dev, smi, "mamba2-2.7b",
                      ["--prompt-len", "512", "--gen", "17"], long_prompt=None)
    return {"reduced_float32_max_abs_err": reduced, "tol_float32": ZOO_F32_TOL,
            "full": [qwen, mamba]}


# ---------------------------------------------------------------------------
# Phase 17: the training path
# ---------------------------------------------------------------------------

# Phase 17's tolerances, those of the CPU tests (tests/test_torch_train.py,
# test_torch_optimizer.py, test_torch_train_launcher.py): float32 gradients
# per parameter within 1e-4 of that parameter's largest entry; one AdamW
# update from identical gradients at float32 rounding (rtol 2e-6, atol
# 1e-9); loss rtol 1e-5.  The microbatch test's (the JAX package's): loss
# rtol 2e-5, parameters rtol 3e-3 atol 3e-5.  Whole steps are not compared
# parameter by parameter across card and host: AdamW's first step is about
# lr * sign(g), and a gradient within summation noise of 0 may flip.
TRAIN_GRAD_RTOL = 1e-4
TRAIN_UPDATE_TOL = dict(rtol=2e-6, atol=1e-9)
TRAIN_MB_TOL = dict(loss_rtol=2e-5, rtol=3e-3, atol=3e-5)
# two float32 sums of every gradient's square in two orders
TRAIN_GNORM_RTOL = 1e-3
TRAIN_OPT = dict(lr=1e-3, total_steps=40, warmup_steps=2)
# (g) and (h): the training shape is TRAIN_4K's length; qwen3-8b cut to 20
# of its 36 layers (see _train_full)
QWEN_TRAIN_LAYERS = 20
BF16_PEAK_FLOPS = 989e12       # H100 SXM dense bf16, NVIDIA's data sheet
# (g) and (h)'s peak rate: the launcher's 3e-4 with its one warmup step
# moves every weight of a fresh model by about lr a step (AdamW's first
# steps are about lr * sign(g)), and qwen3-8b's loss rose from 12.6 to 27
# in 4 steps under it (measured on one H100)
TRAIN_FULL_LR = 3e-5


def _train_batch(cfg, seed, batch=4, seq=32):
    """A ``TokenPipeline`` batch (and the encoder-decoder's frames)."""
    import numpy as np

    from repro_torch.data import TokenPipeline

    out = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch, seed=seed).host_slice(0)
    if cfg.encdec:
        out["frames"] = np.random.default_rng(seed).normal(
            size=(batch, seq, cfg.frontend_dim)).astype(np.float32)
    return out


def _train_reduced(dev):
    """Phase 17 (a): every arch, reduced, float32, one ``train_step`` on the
    card against the same step on the host, from the same weights and
    batch: loss, ``grad_norm`` and every gradient; then ``apply_updates``
    on the host from the card's gradients against the card's update."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, apply_updates, init_state,
                                   make_train_step)

    assert not torch.backends.cuda.matmul.allow_tf32
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    out = {}
    for arch in sorted(ARCHS):
        cpu = get_model(arch, reduced=True, device="cpu").init(
            torch.Generator().manual_seed(0))
        gpu = get_model(arch, reduced=True, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
        batch = _train_batch(cpu.cfg, 0)
        res = {}
        for name, m in (("host", cpu), ("card", gpu)):
            st = init_state(m, opt_cfg)
            _, st, met = make_train_step(m, opt_cfg)(m, st, batch)
            res[name] = met
        for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
            a, b = float(res["card"][key]), float(res["host"][key])
            if abs(a - b) > rtol * abs(b):
                raise AssertionError(f"(a) {arch}: {key} card {a} host {b}")
        grad_err = 0.0
        card_grads = {}
        for (k, pc), (_, pg) in zip(cpu.named_parameters(),
                                    gpu.named_parameters()):
            g, w = pg.grad.cpu(), pc.grad
            card_grads[k] = g
            if not w.numel():
                continue
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            if err > TRAIN_GRAD_RTOL * scale + 1e-9:
                raise AssertionError(f"(a) {arch} {k}: gradient card vs host "
                                     f"{err:.3e} > {TRAIN_GRAD_RTOL} x "
                                     f"{scale:.3e}")
            grad_err = max(grad_err, err / (scale + 1e-30))
        host_p = {k: v.clone() for k, v in p0.items()}
        apply_updates(host_p, card_grads, init_state(host_p, opt_cfg),
                      opt_cfg)
        upd_err = 0.0
        for k, pg in gpu.named_parameters():
            got = pg.detach().cpu()
            torch.testing.assert_close(got, host_p[k], **TRAIN_UPDATE_TOL,
                                       msg=lambda m: f"(a) {arch} {k} update "
                                       f"from the card's gradients: {m}")
            upd_err = max(upd_err, float((got - host_p[k]).abs().max()))
        out[arch] = {"loss": float(res["card"]["loss"]),
                     "grad_rel_err": grad_err, "update_max_abs_err": upd_err}
        print(f"   (a) {arch:28s} loss {out[arch]['loss']:.6f} card == host; "
              f"gradients within {grad_err:.2e} of each largest entry; "
              f"update from the card's gradients max |err| {upd_err:.2e}",
              flush=True)
        del cpu, gpu
    return out


def _train_small(dev, smi):
    """Phase 17 (b), (c), (d) on reduced models on the card."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenPipeline
    from repro_torch.models import get_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    def setup(arch="qwen3-8b", batch=4, dtype=None, seed=0):
        m = get_model(arch, reduced=True, device=dev, dtype=dtype).init(
            torch.Generator(device=dev).manual_seed(seed))
        cfg = AdamWConfig(**TRAIN_OPT, state_dtype=dtype or "float32")
        pipe = TokenPipeline(vocab_size=m.cfg.vocab_size, seq_len=32,
                             global_batch=batch, seed=0)
        return m, cfg, pipe, init_state(m, cfg)

    rec = {}
    # (b) the loss falls: the JAX package's test_training_reduces_loss
    model, cfg, pipe, st = setup()
    fn = make_train_step(model, cfg)
    losses = []
    for step in range(15):
        model, st, m = fn(model, st, pipe.host_slice(step))
        losses.append(float(m["loss"]))
    if not (all(map(math.isfinite, losses))
            and losses[-1] < losses[0] - 0.1):
        raise AssertionError(f"(b) the loss did not fall by 0.1: {losses}")
    rec["loss_falls"] = losses
    print(f"   (b) qwen3-8b reduced, 15 steps on the card: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

    # (c) 4 microbatches == 1
    m1, cfg, pipe, s1 = setup(batch=8)
    m4, _, _, s4 = setup(batch=8)
    batch = pipe.host_slice(0)
    _, _, r1 = make_train_step(m1, cfg, n_microbatches=1)(m1, s1, batch)
    _, _, r4 = make_train_step(m4, cfg, n_microbatches=4)(m4, s4, batch)
    l1, l4 = float(r1["loss"]), float(r4["loss"])
    if abs(l1 - l4) > TRAIN_MB_TOL["loss_rtol"] * abs(l1):
        raise AssertionError(f"(c) loss {l1} with 1 microbatch, {l4} with 4")
    worst = 0.0
    for (k, a), (_, b) in zip(m1.named_parameters(), m4.named_parameters()):
        torch.testing.assert_close(b.detach(), a.detach(),
                                   rtol=TRAIN_MB_TOL["rtol"],
                                   atol=TRAIN_MB_TOL["atol"],
                                   msg=lambda m: f"(c) {k}: {m}")
        worst = max(worst, float((a - b).detach().abs().max()))
    rec["microbatches"] = {"loss_1": l1, "loss_4": l4, "param_max_abs": worst}
    print(f"   (c) 4 microbatches == 1 on the card: loss {l4:.6f} vs "
          f"{l1:.6f}, parameters max |diff| {worst:.2e}", flush=True)
    del model, m1, m4

    # (d) bit-exact restart under deterministic algorithms
    torch.use_deterministic_algorithms(True)
    restart = {}
    try:
        runs = [(a, "float32") for a in sorted(ARCHS)]
        runs.append(("qwen3-8b", "bfloat16"))
        for arch, dtype in runs:
            label = f"{arch} {dtype}"
            try:
                ok = _restart_bitexact(setup, arch, dtype)
            except RuntimeError as e:
                if "deterministic" not in str(e):
                    raise
                op = str(e).splitlines()[0][:160]
                restart[label] = {"skipped": op}
                print(f"   (d) {label}: no deterministic CUDA version of an "
                      f"op it runs ({op}); not restarted", flush=True)
                continue
            restart[label] = ok
            print(f"   (d) {label}: saved at step 3, restored, steps 3-5 "
                  f"bit for bit ({ok['tensors']} parameters and moments)",
                  flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    for need in ("qwen3-8b float32", "qwen3-8b bfloat16"):
        if "tensors" not in restart.get(need, {}):
            raise AssertionError(f"(d) {need} was not restarted bit-exact")
    rec["restart"] = restart
    return rec


def _restart_bitexact(setup, arch, dtype):
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import make_train_step

    model, cfg, pipe, st = setup(arch, dtype=dtype)
    fn = make_train_step(model, cfg)
    d = ROOT / "build" / "train_restart" / f"{arch}_{dtype}"
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(str(d), async_save=False)
    extra = {"frames": _train_batch(model.cfg, 1).get("frames")}

    def batch_at(step):
        b = pipe.host_slice(step)
        if model.cfg.encdec:
            b["frames"] = extra["frames"]
        return b

    for step in range(6):
        model, st, _ = fn(model, st, batch_at(step))
        if step == 2:
            mgr.save(3, (model, st))
    fresh, _, _, fst = setup(arch, dtype=dtype, seed=1)
    (fresh, fst), man = mgr.restore((fresh, fst))
    if man["step"] != 3 or int(fst.step) != 3:
        raise AssertionError(f"(d) {arch}: restored step {man['step']}")
    fn2 = make_train_step(fresh, cfg)
    for step in range(3, 6):
        fresh, fst, _ = fn2(fresh, fst, batch_at(step))
    n = 0
    for (k, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"(d) {arch} {dtype}: {k} differs after the "
                                 "restart")
        n += 1
    for k in st.m:
        if not (torch.equal(st.m[k], fst.m[k])
                and torch.equal(st.v[k], fst.v[k])):
            raise AssertionError(f"(d) {arch} {dtype}: moments of {k} differ")
        n += 2
    shutil.rmtree(d, ignore_errors=True)
    return {"tensors": n}


def _train_cmd(dev, *args):
    """The launcher's command line; on the card ``--device`` is left at its
    default."""
    extra = [] if dev.type == "cuda" else ["--device", dev.type]
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-8b", "--reduced"] + extra + list(args)


def _train_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(extra)
    return env


def _train_launcher(dev, smi):
    """Phase 17 (e): the launcher on the card, SIGTERM, ``--resume``;
    (f) ``--data-mesh 2`` as two gloo ranks sharing the card against one
    NCCL rank on the whole batch."""
    import shutil
    import signal
    import socket

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import get_model

    base = ROOT / "build" / "train_launch"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    rec = {}
    # (e)
    ck = base / "run"
    args = ["--steps", "100000", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(ck), "--ckpt-every", "5", "--log-every", "50"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(_train_cmd(dev, *args), env=_train_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=ROOT)
    deadline = time.time() + 300
    while time.time() < deadline and proc.poll() is None:
        if ck.is_dir() and any(n.name.startswith("step_")
                               and ".tmp" not in n.name
                               and (n / "MANIFEST.json").exists()
                               for n in ck.iterdir()):
            break
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=300)
    for line in out.splitlines()[-6:]:
        print(f"   | {line}")
    if proc.returncode != 0 or "SIGTERM received" not in out:
        raise AssertionError(f"(e) the launcher did not checkpoint on "
                             f"SIGTERM (exit {proc.returncode}): {out[-2000:]}")
    resumed = CheckpointManager(str(ck)).latest_step()
    args[args.index("--steps") + 1] = str(resumed + 4)
    run2 = subprocess.run(_train_cmd(dev, *args, "--resume"), env=_train_env(),
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    for line in run2.stdout.splitlines():
        print(f"   | {line}")
    if (run2.returncode != 0
            or f"resumed from step {resumed}" not in run2.stdout
            or run2.stdout.splitlines()[-1] != "done"):
        raise AssertionError(f"(e) --resume failed: {run2.stdout[-1500:]}"
                             f"{run2.stderr[-1500:]}")
    rec["preempt_resume"] = {"resumed_from": resumed,
                             "seconds": time.perf_counter() - t0}
    print(f"   (e) SIGTERM at or after step {resumed}, resumed to "
          f"{resumed + 4}: {rec['preempt_resume']['seconds']:.1f} s "
          f"[{smi}]", flush=True)

    # (f)
    t0 = time.perf_counter()
    common = ["--steps", "3", "--batch", "4", "--seq", "16", "--log-every",
              "1", "--lr", "1e-3"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(_train_cmd(dev, *common, "--ckpt-dir",
                                         str(base / "d1")),
                              env=_train_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT)]
    procs += [subprocess.Popen(
        _train_cmd(dev, *common, "--ckpt-dir", str(base / "d2"), "--data-mesh",
                   "2", "--dist-backend", "gloo"),
        env=_train_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    if [p.returncode for p in procs] != [0, 0, 0]:
        raise AssertionError(f"(f) exits {[p.returncode for p in procs]}: "
                             + " || ".join(o[-1200:] for o in outs))
    losses = [[float(v) for v in re.findall(r"step +\d+ loss (\S+)", o)]
              for o in outs[:2]]
    if len(losses[0]) != 3 or len(losses[1]) != 3 or any(
            abs(a - b) > TRAIN_MB_TOL["loss_rtol"] * abs(a)
            for a, b in zip(*losses)):
        raise AssertionError(f"(f) losses: one NCCL rank {losses[0]}, two "
                             f"gloo ranks {losses[1]}")
    models = []
    for d in ("d1", "d2"):
        m = get_model("qwen3-8b", reduced=True, device=dev)
        _, man = CheckpointManager(str(base / d)).restore(m)
        models.append(m)
    worst = 0.0
    for (k, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        torch.testing.assert_close(b.detach(), a.detach(),
                                   rtol=TRAIN_MB_TOL["rtol"],
                                   atol=TRAIN_MB_TOL["atol"],
                                   msg=lambda m: f"(f) {k}: {m}")
        worst = max(worst, float((a - b).detach().abs().max()))
    rec["data_mesh"] = {"losses_nccl_1": losses[0],
                        "losses_gloo_2": losses[1], "param_max_abs": worst,
                        "process_count": man["process_count"],
                        "seconds": time.perf_counter() - t0}
    print(f"   (f) --data-mesh 2 (two gloo ranks on the card) == one NCCL "
          f"rank: losses {losses[1]} vs {losses[0]}, parameters max |diff| "
          f"{worst:.2e}; {rec['data_mesh']['seconds']:.1f} s [{smi}]",
          flush=True)
    return rec


def _kernel_breakdown(trace_path, top=8):
    """(name, launches, device ms) of the ``top`` kernels by summed device
    time in a ``torch.profiler`` Chrome trace."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    by = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e:
            n, ms = by.get(e["name"], (0, 0.0))
            by[e["name"]] = (n + 1, ms + float(e["dur"]) / 1e3)
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return [(_short_kernel_name(name), n, ms) for name, (n, ms) in rows]


def _short_kernel_name(name):
    """A PyTorch kernel's template name cut to the ``at::native`` names in
    it (the kernel, then its functor), e.g. ``elementwise_kernel/
    gpu_kernel_impl_nocast/exp_kernel_cuda``; any other name's first 80
    characters."""
    parts = []
    for p in re.findall(r"at::native::(?:(?:\(anonymous namespace\)|\w+)::)*"
                        r"(\w+)", name):
        if p not in parts:
            parts.append(p)
    return "/".join(parts)[:120] if parts else name[:80]


def _train_model_flops(model, batch, seq):
    """6 N T plus attention's score and value matmuls (causal, halved), 3x
    for forward and backward: the JAX package's ``model_flops`` for a
    training step."""
    cfg = model.cfg
    tokens = batch * seq
    attn = 0.0
    if cfg.n_heads:
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.layer_kind(i) == "attn")
        attn = 2.0 * tokens * seq * cfg.n_heads * cfg.d_head * 2 / 2 * n_attn
    return 6.0 * model.n_params() * tokens + 3.0 * attn


def _train_full(dev, smi, arch, n_layers, batch, seq, steps=6):
    """Phase 17 (g) / (h): one arch at full width in bf16, ``cfg.remat``
    on, AdamW state in the config's ``opt_state_dtype``, ``steps`` steps on
    ``TokenPipeline`` batches; the last step traced."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: expected remat on and bf16")
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    n = model.n_params()
    opt_cfg = AdamWConfig(lr=TRAIN_FULL_LR, total_steps=steps,
                          warmup_steps=1, state_dtype=cfg.opt_state_dtype)
    state = init_state(model, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_all
    resident = torch.cuda.memory_allocated() - base_alloc
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    tol = _bf16_tol(cfg.n_layers)

    # the memory the step needs, predicted
    vpad = model.lm_head.shape[1]
    sb = {"float32": 4, "bfloat16": 2}[cfg.opt_state_dtype]
    pred = {"weights": 2 * n, "gradients": 2 * n, "adamw_state": 2 * sb * n,
            # every layer's input kept by the checkpoint, bf16
            "saved_layer_inputs": cfg.n_layers * batch * seq * cfg.d_model * 2,
            # bf16 logits, their float32 cast with the tail added, its
            # log-sum-exp input and gradient: about 3 float32 copies
            "loss": batch * seq * vpad * (2 + 3 * 4)}
    pred_total = sum(pred.values())

    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    fn = make_train_step(model, opt_cfg, mark=mark)
    b0 = pipe.host_slice(0)
    with torch.no_grad():
        ref_loss = float(model.loss(b0))
    torch.cuda.synchronize()
    rows = []
    trace = ROOT / "build" / "traces" / f"train_{arch}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof_out = None
    for step in range(steps):
        batch_np = pipe.host_slice(step)
        mark("start")
        t0 = time.perf_counter()
        if step == steps - 1:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                model, state, met = fn(model, state, batch_np)
                torch.cuda.synchronize()
            prof_out = prof
        else:
            model, state, met = fn(model, state, batch_np)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fb_ms = events["start"].elapsed_time(events["grads"])
        up_ms = events["grads"].elapsed_time(events["update"])
        again = math.sqrt(sum(float(torch.sum(p.grad.float().square(),
                                              dtype=torch.float64))
                              for p in model.parameters()))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{arch} step {step}: loss {loss} gnorm "
                                 f"{gnorm}")
        if abs(again - gnorm) > TRAIN_GNORM_RTOL * again:
            raise AssertionError(f"{arch} step {step}: the clip saw norm "
                                 f"{gnorm}, the .grad tensors {again}")
        rows.append({"step": step, "loss": loss, "grad_norm": gnorm,
                     "lr": float(met["lr"]), "step_ms": dt * 1e3,
                     "fwd_bwd_ms": fb_ms, "update_ms": up_ms,
                     "traced": step == steps - 1})
        print(f"   step {step} loss {loss:.4f} gnorm {gnorm:.4f} (from .grad "
              f"{again:.4f}) step {dt * 1e3:.1f} ms: forward+backward "
              f"{fb_ms:.1f} ms, AdamW {up_ms:.1f} ms (CUDA events)"
              f"{' [traced]' if step == steps - 1 else ''}", flush=True)
    first_rel = abs(rows[0]["loss"] - ref_loss) / abs(ref_loss)
    if first_rel > tol:
        raise AssertionError(f"{arch}: the first step's loss "
                             f"{rows[0]['loss']} vs Model.loss without grad "
                             f"{ref_loss}: {first_rel:.4f} > {tol:.4f}")
    peak = torch.cuda.max_memory_allocated() - base_alloc
    prof_out.export_chrome_trace(str(trace))
    kern, _ = _device_intervals(trace)
    if not kern:
        raise AssertionError(f"{arch}: the step's trace holds no kernel")
    busy = _length(_union(kern)) / 1e3
    span = (max(e for _, e in kern) - min(s for s, _ in kern)) / 1e3
    top = _kernel_breakdown(trace)
    timed = [r for r in rows[1:] if not r["traced"]] or rows[-1:]
    step_ms = statistics.median(r["step_ms"] for r in timed)
    fb_ms = statistics.median(r["fwd_bwd_ms"] for r in timed)
    up_ms = statistics.median(r["update_ms"] for r in timed)
    flops = _train_model_flops(model, batch, seq)
    tokens = batch * seq
    rec = {"arch": arch, "layers": cfg.n_layers, "layers_full": full.n_layers,
           "d_model": cfg.d_model, "n_params": n, "dtype": cfg.dtype,
           "opt_state_dtype": cfg.opt_state_dtype, "remat": cfg.remat,
           "batch": batch, "seq": seq, "steps": rows, "init_s": init_s,
           "ref_loss_no_grad": ref_loss, "first_loss_rel_err": first_rel,
           "tol_bf16_rel": tol, "step_ms_median": step_ms,
           "fwd_bwd_ms_median": fb_ms, "update_ms_median": up_ms,
           "update_share": up_ms / step_ms, "tok_s": tokens / step_ms * 1e3,
           "model_flops_per_step": flops,
           "model_flops_share_of_bf16_peak": flops / (step_ms / 1e3)
           / BF16_PEAK_FLOPS,
           "resident_gib_after_init": resident / 2**30,
           "peak_gib": peak / 2**30,
           "predicted_gib": {k: v / 2**30 for k, v in pred.items()},
           "predicted_total_gib": pred_total / 2**30,
           "trace": {"file": str(trace.relative_to(ROOT)),
                     "kernels": len(kern), "device_busy_ms": busy,
                     "traced_span_ms": span, "idle_share": 1.0 - busy / span,
                     "top_kernels": [{"name": nm, "launches": k, "ms": ms}
                                     for nm, k, ms in top]},
           "card": smi}
    print(f"   {arch}: {cfg.n_layers} layers (of {full.n_layers}), d_model "
          f"{cfg.d_model}, {n:,} parameters, batch {batch} x {seq}, bf16, "
          f"AdamW state {cfg.opt_state_dtype}, remat on; init + state "
          f"{init_s:.1f} s", flush=True)
    print(f"   step {step_ms:.1f} ms (median of steps 1-{steps - 2}), "
          f"{rec['tok_s']:,.0f} tok/s; forward+backward {fb_ms:.1f} ms, "
          f"AdamW update {up_ms:.1f} ms ({rec['update_share']:.3f} of the "
          f"step) [{smi}]", flush=True)
    print(f"   model FLOPs a step {flops:.4e} (6 N T + attention): "
          f"{rec['model_flops_share_of_bf16_peak']:.4f} of the dense bf16 "
          f"peak {BF16_PEAK_FLOPS:.3e} FLOP/s [{smi}]", flush=True)
    print(f"   memory: peak allocated {rec['peak_gib']:.3f} GiB (resident "
          f"after init {rec['resident_gib_after_init']:.3f} GiB); predicted "
          f"{rec['predicted_total_gib']:.3f} GiB = " + " + ".join(
              f"{k} {v:.3f}" for k, v in rec["predicted_gib"].items())
          + " (a layer's recompute and its backward not included)",
          flush=True)
    print(f"   trace of step {steps - 1} ({rec['trace']['file']}): "
          f"{len(kern)} kernels, device busy {busy:.1f} ms of {span:.1f} ms, "
          f"idle share {rec['trace']['idle_share']:.3f} [{smi}]", flush=True)
    for nm, k, ms in top:
        print(f"     {ms:9.1f} ms {k:6d} x {nm}", flush=True)
    print(f"   loss {rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f} over "
          f"{steps} steps at peak lr {TRAIN_FULL_LR:g}", flush=True)
    print(f"   first step's loss {rows[0]['loss']:.6f} vs Model.loss "
          f"without grad {ref_loss:.6f}: relative {first_rel:.2e} (tol "
          f"{tol:.4f})", flush=True)
    del model, state, fn, prof_out
    for _ in range(2):
        torch.cuda.empty_cache()
    return rec


def _training(dev, smi):
    """Phase 17: the training path (see the module docstring)."""
    rec = {"reduced_card_vs_host": _train_reduced(dev)}
    rec.update(_train_small(dev, smi))
    rec.update(_train_launcher(dev, smi))
    print("   (g) mamba2-2.7b at full width and depth, TRAIN_4K's length, "
          "batch 2", flush=True)
    rec["mamba2"] = _train_full(dev, smi, "mamba2-2.7b", 64, 2, 4096)
    print(f"   (h) qwen3-8b at full width, {QWEN_TRAIN_LAYERS} of 36 layers, "
          "batch 1 x 4,096.  The cut: at full depth the bf16 weights and "
          "gradients and AdamW's two float32 moments take 12 bytes a "
          "parameter, 12 x 8.19e9 = 98.3 GB > the card's 80 GB; 20 layers "
          "(5.10e9 parameters) take 61.2 GB, plus about 1 GB of saved layer "
          "inputs, a layer's recompute and about 7.5 GB for the float32 "
          "logits, their log-sum-exp and their gradient; 24 layers would "
          "take 70.5 GB before the activations", flush=True)
    rec["qwen3"] = _train_full(dev, smi, "qwen3-8b", QWEN_TRAIN_LAYERS, 1,
                               4096)
    return rec


# ---------------------------------------------------------------------------
# Phase 18: tensor and expert parallelism over a 'model' mesh axis
# ---------------------------------------------------------------------------

# (a)'s limits, float32 on the card against the same card's 1 x 1 run:
# every logit within 1e-5 of the largest, the loss within 1e-6 relative,
# every gradient within 1e-5 of its parameter's largest entry.  The CPU
# (tests/_torch_tp_worker.py) saw at most 7.5e-6 of a gradient's largest
# entry (jamba's D on 1 x 4) and 4.4e-7 of a logit.
TP_F32_TOL = 1e-5
TP_LOSS_RTOL = 1e-6
TP_GRAD_TOL = 1e-5
# (b)-(d): prompt, cache positions and decode steps; (e): layers, batch,
# sequence and steps
TP_PROMPT, TP_MAX_LEN, TP_STEPS = 512, 528, 16
TP_FULL = (("(b)", "arctic-480b", 1), ("(c)", "llama4-maverick-400b-a17b", 1),
           ("(d)", "qwen3-32b", 64))
TP_TRAIN = ("qwen3-8b", 8, 1, 2048, 2)
# (d) cut to this many layers for the float32 forward (37.5 GB)
TP_F32_CUT = ("qwen3-32b", 16)
TP_JOIN_S = 900


def _tp_limit_train(n_layers):
    """(e)'s limits, argued from rounding before the run: the loss is one
    float32 mean of 2,048 terms whose logits are rounded to bf16 (2^-8)
    at other places in the two runs, so it moves by at most one bf16
    rounding of itself, 2^-8 relative; the clip's norm sums squares of
    bf16 gradients, each rounded once more per layer where the split adds
    a partial sum, layers in quadrature: 2^-8 * sqrt(layers)."""
    return 2.0 ** -8, 2.0 ** -8 * n_layers ** 0.5


def _tp_compare_reduced(dev, mesh, rank, data):
    """(a) on one rank: every reduced arch in float32, this mesh against a
    1 x 1 run of the same weights on the same card, for this data rank's
    rows; returns the largest errors, each over its limit's scale."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.models.common import named_slices
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    dr = mesh.get_local_rank("data")
    out = {}
    for arch in sorted(ARCHS):
        gen = lambda: torch.Generator(device=dev).manual_seed(0)
        one = get_model(arch, reduced=True, device=dev).init(gen())
        tp = get_model(arch, reduced=True, device=dev, mesh=mesh).init(gen())
        cfg = one.cfg
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 41)),
                               device=dev)
        frames = None
        if cfg.encdec:
            frames = torch.as_tensor(rng.normal(size=(2, 40, cfg.frontend_dim)),
                                     dtype=torch.float32, device=dev)
        n = 2 // data
        toks = toks[dr * n:(dr + 1) * n]
        frames = None if frames is None else frames[dr * n:(dr + 1) * n]
        worst = {"logits": 0.0, "loss": 0.0, "grads": 0.0}

        def logits(a, b, what):
            err = float((a - b).abs().max()) / float(b.abs().max())
            if err > TP_F32_TOL:
                raise AssertionError(f"rank {rank} {arch} {what}: max |err| "
                                     f"{err:.3e} of the largest logit > "
                                     f"{TP_F32_TOL:g}")
            worst["logits"] = max(worst["logits"], err)

        logits(tp.forward(toks[:, :40], frames=frames),
               one.forward(toks[:, :40], frames=frames), "forward")
        fp = None if frames is None else frames[:, :32]
        lt, ct = tp.prefill(toks[:, :32], 40, frames=fp)
        lo, co = one.prefill(toks[:, :32], 40, frames=fp)
        logits(lt, lo, "prefill")
        if not ct.get("kv_split"):
            raise AssertionError(f"{arch}: the cache is not split over model")
        for i in range(4):
            pos = 32 + i
            lt, ct = tp.decode_step(ct, toks[:, pos:pos + 1], pos)
            lo, co = one.decode_step(co, toks[:, pos:pos + 1], pos)
            logits(lt, lo, f"decode {i}")
        batch = {"tokens": toks[:, :40], "labels": toks[:, 1:]}
        if frames is not None:
            batch["frames"] = frames
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        _, _, mt = make_train_step(tp, ocfg, group=mesh["data"].get_group())(
            tp, init_state(tp, ocfg), batch)
        # the 1 x 1 run on this data rank's rows, its gradients and loss
        # averaged over the data ranks as the train step averages them
        for p in one.parameters():
            p.grad = None
        lo = one.loss(batch)
        lo.backward()
        if data > 1:
            import torch.distributed as dist
            g = mesh["data"].get_group()
            for p in one.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=g)
                p.grad /= data
            lo = lo.detach().reshape(1).clone()
            dist.all_reduce(lo, group=g)
            lo = lo[0] / data
        lo = float(lo.detach())
        err = abs(float(mt["loss"]) - lo) / abs(lo)
        if err > TP_LOSS_RTOL:
            raise AssertionError(f"rank {rank} {arch}: loss {float(mt['loss'])}"
                                 f" vs {lo} ({err:.3e} relative)")
        worst["loss"] = err
        ref = dict(one.named_parameters())
        for k, sl in named_slices(tp):
            want = ref[k].grad
            want = want if sl is None else want.narrow(*sl)
            got = dict(tp.named_parameters())[k].grad
            scale = float(want.abs().max()) if want.numel() else 0.0
            e = float((got - want).abs().max()) if want.numel() else 0.0
            if e > TP_GRAD_TOL * scale + 1e-12:
                raise AssertionError(f"rank {rank} {arch} grad {k}: {e:.3e} "
                                     f"> {TP_GRAD_TOL:g} x {scale:.3e}")
            worst["grads"] = max(worst["grads"], e / scale if scale else 0.0)
        out[arch] = worst
        del one, tp
    torch.cuda.empty_cache()
    return out


def _tp_serve(dev, cfg, mesh, prompts, tokens, forward=False):
    """Prefill ``prompts`` into a TP_MAX_LEN cache and decode TP_STEPS
    steps: greedy on the 1 x 1 run (``tokens`` None), the 1 x 1 run's
    tokens on a mesh.  Steps 0-7 timed plain, 8-13 with the collectives
    timed (``STATS``, a device synchronise around each), 14-15 under
    ``torch.profiler`` for the kernels a step.  ``forward``: also the
    logits of one ``forward`` over the prompt and the fed tokens, at the
    positions the served logits predict from."""
    import torch

    from repro_torch.models import Model
    from repro_torch.parallel import collectives as coll

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = Model(cfg, device=dev, mesh=mesh).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    lg, cache = model.prefill(prompts, TP_MAX_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    rows = [lg[:, -1].float().cpu()]
    toks = [] if tokens is None else list(tokens)
    plain, coll_s, coll_wall, kernels = [], 0.0, 0.0, 0
    import torch.distributed as dist
    shape = (1, 1) if mesh is None else tuple(mesh.shape)
    trace = (ROOT / "build" / "traces" / f"tp_{cfg.name}_{shape[0]}x"
             f"{shape[1]}_rank{dist.get_rank()}.json")
    trace.parent.mkdir(parents=True, exist_ok=True)
    for i in range(TP_STEPS):
        if tokens is None:
            toks.append(int(rows[-1][0, :cfg.vocab_size].argmax()))
        tok = torch.tensor([[toks[i]]], device=dev)
        if i == 8:
            coll.STATS.reset()
            coll.STATS.enabled = True
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i < 14:
            lg, cache = model.decode_step(cache, tok, TP_PROMPT + i)
        else:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                lg, cache = model.decode_step(cache, tok, TP_PROMPT + i)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            kernels += len(_device_intervals(trace)[0])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if i < 8:
            plain.append(dt)
        elif i < 14:
            coll_wall += dt
        if i == 13:
            coll_s = coll.STATS.seconds
            coll.STATS.enabled = False
        rows.append(lg[:, -1].float().cpu())
    peak = torch.cuda.max_memory_allocated()
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    del cache
    fwd = None
    if forward:
        seq = torch.cat([prompts, torch.tensor([toks[:TP_STEPS - 1]],
                                               device=dev)], dim=1)
        fwd = model.forward(seq)[0, TP_PROMPT - 1:].float().cpu()
    del model
    torch.cuda.empty_cache()
    return {"logits": torch.cat(rows[:-1]), "tokens": toks, "forward": fwd,
            "init_s": init_s, "prefill_ms": prefill_ms,
            "decode_ms_per_step": 1e3 * sum(plain) / len(plain),
            "kernels_per_step": kernels / (TP_STEPS - 14),
            "collective_share": coll_s / coll_wall if coll_wall else 0.0,
            "peak_gib": peak / 2**30, "weights_gib": held / 2**30}


def _tp_against_f32(dev, mesh, rank):
    """(d) at ``TP_F32_CUT`` layers: the bf16 forward over one 1 x
    TP_MAX_LEN sequence on 1 x 1 (rank 0) and on 1 x 2, and a float32 1 x 1
    forward of the same weights rounded to bf16 (rank 0); on rank 0 the
    largest per-row relative L2 of each bf16 run against float32 and of one
    against the other.  Each bf16 run within ``_bf16_tol(layers)`` of
    float32."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    arch, layers = TP_F32_CUT
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    seq = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, TP_MAX_LEN)), device=dev)

    def forward(c, m):
        model = Model(c, device=dev, mesh=m).init(
            torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.to(torch.bfloat16))
        out = model.forward(seq)[0].float().cpu()
        del model
        torch.cuda.empty_cache()
        return out

    if rank == 0:
        one = forward(cfg, None)
        want = forward(dataclasses.replace(cfg, dtype="float32"), None)
    dist.barrier()
    two = forward(cfg, mesh)
    if rank != 0:
        return None
    v = cfg.vocab_size
    rec = {"arch": arch, "layers": layers, "tol": _bf16_tol(layers),
           "1x1 vs f32": _rel_rows(one, want, v)[0],
           "1x2 vs f32": _rel_rows(two, want, v)[0],
           "1x2 vs 1x1": _rel_rows(two, one, v)[0]}
    for k in ("1x1 vs f32", "1x2 vs f32"):
        if not rec[k] <= rec["tol"]:
            raise AssertionError(f"{arch} at {layers} layers: bf16 {k} "
                                 f"{rec[k]:.4f} > {rec['tol']:.4f}")
    return rec


def _tp_train(dev, cfg, mesh, batch, steps):
    """(e): ``steps`` train steps of ``cfg`` on one batch; losses, clip
    norms, step ms, peak memory."""
    import torch

    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev, mesh=mesh).init(
        torch.Generator(device=dev).manual_seed(0))
    ocfg = AdamWConfig(lr=3e-5, warmup_steps=1, total_steps=steps,
                       state_dtype=cfg.opt_state_dtype)
    state = init_state(model, ocfg)
    # one data rank: no data all-reduce
    step = make_train_step(model, ocfg)
    losses, norms, ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms, "step_ms": ms,
            "peak_gib": peak / 2**30}


def _tp_collective_ms(mesh, dev, runs=20):
    """Host wall ms of one gloo all-reduce and one all-gather of float32
    tensors on the card over the model group, by element count, each
    timed from a device synchronise to the next."""
    import torch

    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd

    out = {}
    with shd.sharding_ctx(mesh):
        for n in (1024, 5120, 1 << 20, 5 << 20):
            x = torch.ones(n, device=dev)
            for name, fn in (("all_reduce", lambda: coll.all_reduce(x)),
                             ("all_gather", lambda: coll.all_gather(x, 0))):
                fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
                out[f"{name} {n}"] = (time.perf_counter() - t) * 1e3 / runs
    return out


def _tp_rank(rank, world, store, out_dir):
    """One of phase 18's gloo ranks sharing the card: (a) on a (world/2, 2)
    mesh; with two ranks also (b)-(e), rank 0 first running each alone on
    1 x 1 while rank 1 waits."""
    import dataclasses
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TP_JOIN_S))
    out = {"rank": rank}
    try:
        data = world // 2
        mesh = make_host_mesh(data, 2, device_type="cpu")
        t = time.perf_counter()
        out["reduced"] = _tp_compare_reduced(dev, mesh, rank, data)
        out["reduced_s"] = time.perf_counter() - t
        if world == 2:
            out["collective_ms"] = _tp_collective_ms(mesh, dev)
            for label, arch, layers in TP_FULL:
                cfg = dataclasses.replace(get_config(arch), n_layers=layers)
                prompts = torch.as_tensor(np.random.default_rng(0).integers(
                    0, cfg.vocab_size, (1, TP_PROMPT)), device=dev)
                drift = label == "(d)"
                one = _tp_serve(dev, cfg, None, prompts, None, drift) \
                    if rank == 0 else None
                toks = [one["tokens"] if rank == 0 else None]
                dist.broadcast_object_list(toks, src=0)
                two = _tp_serve(dev, cfg, mesh, prompts, toks[0], drift)
                skip = ("logits", "tokens", "forward")
                rec = {"two": {k: v for k, v in two.items()
                               if k not in skip}}
                if rank == 0:
                    rel, mx = _rel_rows(two["logits"], one["logits"],
                                        cfg.vocab_size)
                    tol = _bf16_tol(layers)
                    if not (torch.isfinite(two["logits"]).all() and rel <= tol):
                        raise AssertionError(
                            f"{label} {arch}: 1 x 2 logits differ from 1 x 1 "
                            f"by {rel:.4f} relative L2 > {tol:.4f}")
                    rec.update(one={k: v for k, v in one.items()
                                    if k not in skip},
                               rel_l2=rel, max_abs_err=mx, tol=tol)
                    if drift:
                        v = cfg.vocab_size
                        rec["bf16_paths"] = {
                            "1x1 decode vs 1x1 forward": _rel_rows(
                                one["logits"], one["forward"], v)[0],
                            "1x2 decode vs 1x2 forward": _rel_rows(
                                two["logits"], two["forward"], v)[0],
                            "1x2 forward vs 1x1 forward": _rel_rows(
                                two["forward"], one["forward"], v)[0]}
                out[label] = rec
                dist.barrier()
            out["against_f32"] = _tp_against_f32(dev, mesh, rank)
            arch, layers, b, s, steps = TP_TRAIN
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            rng = np.random.default_rng(0)
            toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
            batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
            one = _tp_train(dev, cfg, None, batch, steps) if rank == 0 \
                else None
            dist.barrier()
            two = _tp_train(dev, cfg, mesh, batch, steps)
            rec = {"two": two}
            if rank == 0:
                lt, nt = _tp_limit_train(layers)
                for a, b_ in zip(two["losses"], one["losses"]):
                    if abs(a - b_) > lt * abs(b_):
                        raise AssertionError(f"(e) loss {a} vs {b_} > {lt:g}")
                for a, b_ in zip(two["grad_norms"], one["grad_norms"]):
                    if not math.isfinite(a) or abs(a - b_) > nt * abs(b_):
                        raise AssertionError(f"(e) clip norm {a} vs {b_} > "
                                             f"{nt:g}")
                rec.update(one=one, loss_rtol=lt, norm_rtol=nt)
            out["(e)"] = rec
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _tp_spawn(world, out_dir, target=None):
    """Run ``target`` (``_tp_rank`` by default) on ``world`` gloo ranks
    sharing the card; their JSON records, and the seconds it took."""
    import torch.multiprocessing as tmp

    target = target or _tp_rank

    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*"):
        f.unlink()
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=target, daemon=True,
                         args=(r, world, str(out_dir / "gloo.store"),
                               str(out_dir))) for r in range(world)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"{target.__name__}, {world} gloo ranks: "
                             f"exit codes {codes}")
    return ([json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(world)], time.perf_counter() - t)


def _tp_sizes():
    """Parameters and bf16 GB of the archs one card holds only in part,
    at the depths that matter (counted from the specs, nothing built)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.common import param_count
    from repro_torch.models.transformer import model_specs

    out = {}
    for arch, depths in (("arctic-480b", (1, 2, 35)),
                         ("llama4-maverick-400b-a17b", (1, 2, 48)),
                         ("jamba-1.5-large-398b", (8, 72)),
                         ("qwen3-32b", (64,)), ("chameleon-34b", (48,))):
        for n in depths:
            cfg = dataclasses.replace(get_config(arch), n_layers=n)
            k = param_count(model_specs(cfg))
            out[f"{arch} {n} layers"] = {"params": k, "bf16_gb": 2 * k / 1e9}
    return out


def _tensor_parallel(smi):
    """Phase 18 (see the module docstring)."""
    rec = {"card": smi, "sizes": _tp_sizes()}
    print("   sizes: " + "; ".join(
        f"{k} {v['params'] / 1e9:.2f}e9 parameters, {v['bf16_gb']:.1f} GB "
        "bf16" for k, v in rec["sizes"].items()), flush=True)
    for world in (4, 2):
        ranks, secs = _tp_spawn(world, ROOT / "build" / f"tp{world}")
        shape = f"({world // 2}, 2)"
        worst = {k: max(r["reduced"][a][k] for r in ranks
                        for a in r["reduced"])
                 for k in ("logits", "loss", "grads")}
        reduced_s = max(r["reduced_s"] for r in ranks)
        rec[f"reduced {shape}"] = dict(worst, seconds=reduced_s,
                                       spawn_seconds=secs)
        print(f"   (a) mesh {shape}, {world} gloo ranks sharing the card, "
              f"{len(ranks[0]['reduced'])} reduced archs in float32 against "
              f"the same card's 1 x 1 run: forward, prefill, 4 decode steps, "
              f"a train step; worst logit error {worst['logits']:.3e} of the "
              f"largest (limit {TP_F32_TOL:g}), loss {worst['loss']:.3e} "
              f"relative ({TP_LOSS_RTOL:g}), gradient {worst['grads']:.3e} of "
              f"its largest entry ({TP_GRAD_TOL:g}); {reduced_s:.3f} s, the "
              f"ranks' whole run {secs:.3f} s with the start-up [{smi}]",
              flush=True)
    rec["collective_ms"] = ranks[0]["collective_ms"]
    print("   gloo collectives of float32 on the card over the two ranks' "
          "model group, ms each: " + ", ".join(
              f"{k} {v:.3f}" for k, v in rec["collective_ms"].items())
          + f" [{smi}]", flush=True)
    for label, arch, layers in TP_FULL:
        r0, r1 = ranks[0][label], ranks[1][label]
        one, two = r0["one"], r0["two"]
        print(f"   {label} {arch} at full width, {layers} layer(s), bf16, "
              f"1 x {TP_PROMPT} prefill into {TP_MAX_LEN} positions and "
              f"{TP_STEPS} decode steps: 1 x 2 vs 1 x 1 relative L2 "
              f"{r0['rel_l2']:.4e} (limit {r0['tol']:.4f}), max |err| "
              f"{r0['max_abs_err']:.4f} [{smi}]", flush=True)
        for name, o, peaks in (("1 x 1", one, [one["peak_gib"]]),
                               ("1 x 2", two, [two["peak_gib"],
                                               r1["two"]["peak_gib"]])):
            print(f"     {name}: init {o['init_s']:.3f} s, prefill "
                  f"{o['prefill_ms']:.3f} ms, decode "
                  f"{o['decode_ms_per_step']:.3f} ms/step, "
                  f"{o['kernels_per_step']:.1f} kernels a step, "
                  f"collectives {100 * o['collective_share']:.1f}% of the "
                  f"wall, weights {o['weights_gib']:.3f} GiB a rank, peak "
                  f"{', '.join(f'{p:.3f}' for p in peaks)} GiB a rank",
                  flush=True)
        rec[label] = {"arch": arch, "layers": layers, "rel_l2": r0["rel_l2"],
                      "tol": r0["tol"], "one": one, "two": two,
                      "two_rank1": r1["two"]}
        if "bf16_paths" in r0:
            rec[label]["bf16_paths"] = r0["bf16_paths"]
            print("     two bf16 paths over the same tokens, relative L2: "
                  + ", ".join(f"{k} {x:.4e}" for k, x in
                              r0["bf16_paths"].items()) + f" [{smi}]",
                  flush=True)
    f32 = rec["against_f32"] = ranks[0]["against_f32"]
    print(f"   (d) {f32['arch']} cut to {f32['layers']} layers, bf16 forward "
          f"over 1 x {TP_MAX_LEN} against a float32 1 x 1 forward of the same "
          f"weights, relative L2: 1 x 1 {f32['1x1 vs f32']:.4e}, 1 x 2 "
          f"{f32['1x2 vs f32']:.4e} (limit {f32['tol']:.4f}); 1 x 2 against "
          f"1 x 1 {f32['1x2 vs 1x1']:.4e} [{smi}]", flush=True)
    e0, e1 = ranks[0]["(e)"], ranks[1]["(e)"]
    arch, layers, b, s, steps = TP_TRAIN
    print(f"   (e) {arch} at full width, {layers} layers, bf16, {steps} train "
          f"steps at {b} x {s}: losses 1 x 1 {e0['one']['losses']} vs 1 x 2 "
          f"{e0['two']['losses']} (limit {e0['loss_rtol']:.4g} relative); "
          f"clip norms {e0['one']['grad_norms']} vs {e0['two']['grad_norms']}"
          f" (limit {e0['norm_rtol']:.4g}); step ms 1 x 1 "
          f"{e0['one']['step_ms']}, 1 x 2 {e0['two']['step_ms']}; peak "
          f"{e0['one']['peak_gib']:.3f} GiB vs {e0['two']['peak_gib']:.3f} "
          f"and {e1['two']['peak_gib']:.3f} GiB a rank [{smi}]", flush=True)
    rec["(e)"] = {"arch": arch, "layers": layers, "one": e0["one"],
                  "two": e0["two"], "two_rank1": e1["two"],
                  "loss_rtol": e0["loss_rtol"], "norm_rtol": e0["norm_rtol"]}
    return rec


# ---------------------------------------------------------------------------
# Phase 19: the dry run against the card
# ---------------------------------------------------------------------------

# (a): the archs run whole on one card, each a prefill of DRY_BATCH x
# DRY_PROMPT into DRY_MAX_LEN positions and DRY_STEPS decode steps; the dry
# run counts the prefill cell and one decode step into that cache
DRY_ARCHS = ("qwen3-8b", "mistral-nemo-12b", "starcoder2-7b",
             "seamless-m4t-large-v2", "chameleon-34b")
DRY_BATCH, DRY_PROMPT, DRY_MAX_LEN, DRY_STEPS = 4, 2048, 2080, 16
# The predicted peak (the dry run's live fake storages at their most)
# against torch.cuda.max_memory_allocated less what was live before the
# step and is no argument.  The caching allocator rounds every block up to
# 512 bytes (a few thousand blocks a step: under 2 MB); cuBLAS's workspace
# (32 MiB a stream under CUBLAS_WORKSPACE_CONFIG=:4096:8) exists from the
# earlier phases and sits in what was live before; a kernel's own scratch
# (sort, top-k, index) comes from the allocator unseen by the count, a few
# MB at these shapes.  Against peaks of 5-75 GB that is under 1 %; the
# limit is 5 % (PERF.md §6 argues it).
DRY_PEAK_RTOL = 0.05
# (b): qwen3-8b cut to this many layers on (1, 2); a decode step into
# DRY_TP_CACHE positions and a train step of one DRY_TP_SEQ sequence
DRY_TP = ("qwen3-8b", 8)
DRY_TP_CACHE, DRY_TP_SEQ = 528, 512
DRY_REDUCED = [
    "mesh 16 x 16 (256 ranks) cut to one card, 1 x 1, for (a): what one "
    "card measures; (b) on (1, 2) gloo ranks sharing the card",
    f"prefill_32k (32 x 32,768) cut to {DRY_BATCH} x {DRY_PROMPT} into "
    f"{DRY_MAX_LEN} cache positions: chameleon-34b's 68.6 GB of weights "
    "leave about 10 GB of the card",
    f"decode_32k (128 sequences, a 32,768-position cache) cut to "
    f"{DRY_BATCH} x {DRY_MAX_LEN}, {DRY_STEPS} steps",
    "train_4k and long_500k not run in (a): AdamW's moments do not fit "
    "beside these weights on one card; long_500k is for SSM archs",
    f"(b) qwen3-8b cut to {DRY_TP[1]} of 36 layers; decode 1 x "
    f"{DRY_TP_CACHE}, train 1 x {DRY_TP_SEQ}",
]


def _dry_shapes():
    from repro_torch.models.config import ShapeSpec
    return (ShapeSpec("dry_prefill", DRY_PROMPT, DRY_BATCH, "prefill"),
            ShapeSpec("dry_decode", DRY_MAX_LEN, DRY_BATCH, "decode"))


def _dry_tp_shapes():
    from repro_torch.models.config import ShapeSpec
    return (ShapeSpec("dry_tp_decode", DRY_TP_CACHE, 1, "decode"),
            ShapeSpec("dry_tp_train", DRY_TP_SEQ, 1, "train"))


def _dry_record(count, cfg, shape, n_devices):
    from repro_torch.roofline.analysis import analyze, model_flops

    roof = analyze(count, model_flops(cfg, shape), n_devices)
    return {"flops": count.flops, "bytes_accessed": count.bytes_accessed,
            "argument_bytes": count.argument_bytes,
            "peak_bytes": count.peak_bytes, "temp_bytes": count.temp_bytes,
            "t_compute_ms": roof.t_compute * 1e3,
            "t_memory_ms": roof.t_memory * 1e3,
            "t_collective_ms": roof.t_collective * 1e3,
            "step_time_ms": roof.step_time * 1e3,
            "collectives": [list(c) for c in count.collective_log],
            "n_ops": count.n_ops, "count_s": count.seconds}


def _dry_fake(out_path):
    """Phase 19's dry-run counts on fake ``cuda`` tensors, in a process of
    its own (the dry run makes its own fake process group): (a) every
    arch's prefill and decode cell on 1 x 1, then (b) qwen3-8b's on a
    fake (1, 2) group."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out = {}
    for arch in DRY_ARCHS:
        cfg = get_config(arch)
        for shape in _dry_shapes():
            max_len = DRY_MAX_LEN if shape.kind == "prefill" else None
            _, count, _, _ = dryrun.count_cell(arch, shape, None,
                                               device="cuda", max_len=max_len)
            out[f"{arch} {shape.kind}"] = _dry_record(count, cfg, shape, 1)
    arch, layers = DRY_TP
    cfg = dryrun._depth_variant(get_config(arch), layers)
    with dryrun.fake_world(2):
        mesh = dryrun.fake_mesh(1, 2)
        for shape in _dry_tp_shapes():
            _, count, _, _ = dryrun.count_cell(arch, shape, mesh,
                                               device="cuda", cfg_override=cfg)
            out[f"tp {shape.kind}"] = _dry_record(count, cfg, shape, 2)
    out["seconds"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out))


def _dry_counted(fn, args):
    """``fn(*args)`` under the dry run's counters on real tensors: its
    result, the count and the peak the card's allocator saw, less what was
    live before and is no argument."""
    import torch

    from repro_torch.roofline.count import count_step

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, count = count_step(fn, args, track_memory=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - (before - count.argument_bytes)
    return out, count, peak


def _dry_card(dev, arch, smi):
    """(a) on the card: ``arch`` whole in bf16 from seed 0, the prefill and
    the first decode step counted (FLOPs, arguments, the allocator's peak),
    the other decode steps timed (wall) and profiled (busy), and the
    logits against ``forward``."""
    import numpy as np
    import torch

    from repro_torch.launch import specs

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pshape, _ = _dry_shapes()
    kind, args, info = specs.input_specs(
        arch, pshape, None, device="cuda:0", mode=contextlib.nullcontext(),
        max_len=DRY_MAX_LEN)
    model = info["model"]
    cfg = model.cfg
    model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    args[1].copy_(torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (DRY_BATCH, DRY_PROMPT))))
    frames = None
    if cfg.encdec:
        frames = args[2]
        frames.copy_(torch.as_tensor(rng.standard_normal(frames.shape,
                                                         dtype=np.float32)))
    init_s = time.perf_counter() - t0
    (logits, cache), pre, pre_peak = _dry_counted(specs.step_fn(kind, info),
                                                  args)
    got = [logits[:, -1:]]
    toks = [logits[:, -1:, :cfg.vocab_size].argmax(-1).to(torch.int32)]
    decode = specs.step_fn("decode", info)
    (lg, cache), dec, dec_peak = _dry_counted(
        decode, (args[0], cache, toks[-1], DRY_PROMPT))
    got.append(lg)
    toks.append(lg[..., :cfg.vocab_size].argmax(-1).to(torch.int32))
    pos = DRY_PROMPT + 1
    timed = (DRY_STEPS - 1) // 2
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        lg, cache = model.decode_step(cache, toks[-1], pos)
        got.append(lg)
        toks.append(lg[..., :cfg.vocab_size].argmax(-1).to(torch.int32))
        pos += 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / timed
    traced = DRY_STEPS - 1 - timed
    trace = ROOT / "build" / "traces" / f"dryrun_decode_{arch}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            lg, cache = model.decode_step(cache, toks[-1], pos)
            got.append(lg)
            toks.append(lg[..., :cfg.vocab_size].argmax(-1).to(torch.int32))
            pos += 1
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    kern, _ = _device_intervals(trace)
    if not kern:
        raise AssertionError(f"{arch}: the decode trace holds no kernel")
    busy_ms = _length(_union(kern)) / 1e3 / traced
    del cache
    torch.cuda.empty_cache()
    # prefill + DRY_STEPS - 1 decode steps against forward over the sequence
    seq = torch.cat([args[1].long()] + [x.long() for x in
                                         toks[:DRY_STEPS - 1]], dim=1)
    want = model.forward(seq, frames=frames)[:, DRY_PROMPT - 1:]
    got = torch.cat(got[:DRY_STEPS], dim=1)
    rel, mx = _rel_rows(got, want, cfg.vocab_size)
    tol = _bf16_tol(cfg.n_layers)
    if not (torch.isfinite(got).all() and rel <= tol):
        raise AssertionError(f"{arch}: prefill/decode logits differ from "
                             f"forward by {rel:.4f} > {tol:.4f}")
    out = {"arch": arch, "layers": cfg.n_layers, "n_params": model.n_params(),
           "init_s": init_s, "rel_l2": rel, "max_abs_err": mx, "tol": tol,
           "prefill": {"flops": pre.flops, "argument_bytes":
                       pre.argument_bytes, "peak_bytes": pre_peak},
           "decode": {"flops": dec.flops, "argument_bytes":
                      dec.argument_bytes, "peak_bytes": dec_peak,
                      "busy_ms_per_step": busy_ms,
                      "wall_ms_per_step": wall_ms,
                      "kernels_per_step": len(kern) / traced},
           "seconds": time.perf_counter() - t0}
    print(f"   {arch}: {cfg.n_layers} layers, {model.n_params():,} "
          f"parameters in bf16, init {init_s:.3f} s; prefill {DRY_BATCH}x"
          f"{DRY_PROMPT} + {DRY_STEPS} decode steps vs forward: relative L2 "
          f"{rel:.4e} (tol {tol:.4f}) [{smi}]", flush=True)
    del args, info, model, want, got, logits
    torch.cuda.empty_cache()
    return out


def _dry_rank(rank, world, store, out_dir):
    """(b) on one of two gloo ranks sharing the card: qwen3-8b cut to
    ``DRY_TP`` layers on (1, 2), one decode step and one train step from
    seed 0, their collectives counted at the dispatcher."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _depth_variant
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline.count import count_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TP_JOIN_S))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, 2, device_type="cpu")
        arch, layers = DRY_TP
        cfg = _depth_variant(get_config(arch), layers)
        for shape in _dry_tp_shapes():
            kind, args, info = specs.input_specs(
                arch, shape, mesh, cfg_override=cfg, device="cuda:0",
                mode=contextlib.nullcontext())
            info["model"].init(torch.Generator(device=dev).manual_seed(0))
            toks = torch.as_tensor(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (1, shape.seq_len + 1)), dtype=torch.int32)
            if kind == "train":
                args[2]["tokens"].copy_(toks[:, :-1])
                args[2]["labels"].copy_(toks[:, 1:])
            else:
                args[2].copy_(toks[:, :1])
            res, count = count_step(specs.step_fn(kind, info), args,
                                    track_memory=False)
            value = res[1]["loss"] if kind == "train" else res[0]
            out[kind] = {"collectives": [list(c) for c in
                                         count.collective_log],
                         "flops": count.flops,
                         "finite": bool(torch.isfinite(value).all())}
            del args, info, res, value
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _dry_run(dev, smi):
    """Phase 19 (see the module docstring)."""
    import torch

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    fake_path = out_dir / "fake.json"
    fake_path.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke._dry_fake({str(fake_path)!r})")
    fake_proc = subprocess.Popen([sys.executable, "-c", code])
    try:
        ranks, tp_s = _tp_spawn(2, out_dir / "tp", target=_dry_rank)
        cells = [_dry_card(dev, arch, smi) for arch in DRY_ARCHS]
        if fake_proc.wait(timeout=600) != 0:
            raise AssertionError(f"the dry run's counts exited "
                                 f"{fake_proc.returncode}")
    finally:
        if fake_proc.poll() is None:
            fake_proc.kill()
            fake_proc.wait(10)
    fake = json.loads(fake_path.read_text())
    print(f"   the dry run's counts on fake cuda tensors: "
          f"{fake['seconds']:.1f} s in a process of their own", flush=True)
    rec = {"card": smi, "reduced": DRY_REDUCED, "peak_rtol": DRY_PEAK_RTOL,
           "fake_seconds": fake["seconds"], "cells": {}}
    for c in cells:
        arch = c["arch"]
        row = {"layers": c["layers"], "n_params": c["n_params"],
               "rel_l2": c["rel_l2"], "tol": c["tol"],
               "seconds": c["seconds"]}
        for kind in ("prefill", "decode"):
            card, count = c[kind], fake[f"{arch} {kind}"]
            if card["flops"] != count["flops"]:
                raise AssertionError(f"{arch} {kind}: the card's step counts "
                                     f"{card['flops']:.6e} FLOPs, the dry "
                                     f"run {count['flops']:.6e}")
            if card["argument_bytes"] != count["argument_bytes"]:
                raise AssertionError(f"{arch} {kind}: argument bytes "
                                     f"{card['argument_bytes']} on the card, "
                                     f"{count['argument_bytes']} counted")
            rel = (card["peak_bytes"] - count["peak_bytes"]) / \
                count["peak_bytes"]
            if abs(rel) > DRY_PEAK_RTOL:
                raise AssertionError(f"{arch} {kind}: peak "
                                     f"{card['peak_bytes']} on the card, "
                                     f"{count['peak_bytes']} predicted "
                                     f"({rel:+.4f} > {DRY_PEAK_RTOL})")
            row[kind] = dict(card, predicted_peak_bytes=count["peak_bytes"],
                             peak_rel=rel, count=count)
            line = (f"   {arch} {kind}: FLOPs {card['flops']:.6e} (card == "
                    f"count), arguments {card['argument_bytes'] / 2**30:.3f} "
                    f"GiB (equal), peak {card['peak_bytes'] / 2**30:.3f} GiB "
                    f"vs predicted {count['peak_bytes'] / 2**30:.3f} GiB "
                    f"({100 * rel:+.3f} %); roofline: compute "
                    f"{count['t_compute_ms']:.3f} ms, memory "
                    f"{count['t_memory_ms']:.3f} ms")
            if kind == "decode":
                busy, bound = card["busy_ms_per_step"], count["step_time_ms"]
                if busy < bound:
                    raise AssertionError(
                        f"{arch}: a decode step kept the card busy "
                        f"{busy:.3f} ms, below the roofline's {bound:.3f} ms "
                        "(an impossible reading)")
                row[kind].update(busy_over_bound=busy / bound,
                                 wall_over_bound=card["wall_ms_per_step"]
                                 / bound)
                line += (f"; a step busy {busy:.3f} ms "
                         f"({busy / bound:.2f}x the bound), wall "
                         f"{card['wall_ms_per_step']:.3f} ms "
                         f"({card['wall_ms_per_step'] / bound:.2f}x), "
                         f"{card['kernels_per_step']:.0f} kernels")
            print(line + f" [{smi}]", flush=True)
        rec["cells"][arch] = row
    tp = {"arch": DRY_TP[0], "layers": DRY_TP[1], "seconds": tp_s}
    for kind in ("decode", "train"):
        count = fake[f"tp {kind}"]["collectives"]
        for r in ranks:
            if not r[kind]["finite"]:
                raise AssertionError(f"(b) rank {r['rank']} {kind}: "
                                     "non-finite output")
            if r[kind]["collectives"] != count:
                raise AssertionError(
                    f"(b) {kind} on rank {r['rank']}: the gloo collectives "
                    f"{r[kind]['collectives'][:6]}... ({len(r[kind]['collectives'])}) "
                    f"differ from the dry run's {count[:6]}... ({len(count)})")
        kinds = {}
        for k, n, b in count:
            kinds.setdefault(k, [0, 0])
            kinds[k][0] += 1
            kinds[k][1] += b
        tp[kind] = {"collectives": len(count), "by_kind": kinds,
                    "flops": ranks[0][kind]["flops"]}
        print(f"   (b) {DRY_TP[0]}, {DRY_TP[1]} layers, (1, 2) gloo ranks: "
              f"one {kind} step's collectives equal the dry run's on a fake "
              f"(1, 2) group on both ranks: {len(count)} ("
              + ", ".join(f"{k} {n} of {b / 2**20:.3f} MiB"
                          for k, (n, b) in kinds.items()) + f") [{smi}]",
              flush=True)
    rec["tp"] = tp
    torch.cuda.empty_cache()
    return rec


# Phase 20: the seven examples under examples/torch/, each at its default
# arguments, then streaming_bigdata and count_server at the paper's §4.3
# size, each with its own host oracle.  Two cuts keep the phase under 180 s
# (on the card, NVIDIA H100 80GB HBM3 at 700 W, the uncut phase took
# 293.4 s): minority_report_census runs one p_y of its three (the three
# took 110.5 s, the pure-Python full FP-growth baseline 20.4-26.5 s of
# each, the three engines 1.3 s at p_y 0.01 and 35.3 s at 0.25), and
# streaming_bigdata --backend streaming runs
# EXAMPLE_STREAM_ROWS rows (83.3 s at 1,000,000: 6,956 host-driven chunk
# counts of 1,024 rows, and its host oracle, 19.4 s in _example_oracles).
EXAMPLE_BIG_ROWS = 1_000_000
EXAMPLE_STREAM_ROWS = 500_000
EXAMPLE_CENSUS_PY = "0.01"
EXAMPLE_CUTS = (
    f"minority_report_census at p_y {EXAMPLE_CENSUS_PY} only (its default "
    "runs 0.01, 0.05 and 0.25)",
    f"streaming_bigdata --backend streaming at {EXAMPLE_STREAM_ROWS} rows, "
    f"not {EXAMPLE_BIG_ROWS}",
)
EXAMPLE_RUNS = (
    ("quickstart", ()),
    ("incremental_mining", ()),
    ("corpus_pattern_mining", ()),
    ("count_server", ()),
    ("rule_server", ()),
    ("streaming_bigdata", ()),
    ("minority_report_census", (EXAMPLE_CENSUS_PY,)),
    ("streaming_bigdata", ("--rows", str(EXAMPLE_STREAM_ROWS),
                           "--backend", "streaming")),
    ("streaming_bigdata", ("--rows", str(EXAMPLE_BIG_ROWS),
                           "--backend", "auto")),
    ("count_server", (str(EXAMPLE_BIG_ROWS),)),
)
# the paper-faithful host engine only: no count reaches the device
EXAMPLE_HOST_ONLY = ("incremental_mining",)
# the line each example prints once its own exactness assertions hold
EXAMPLE_EXACT = {
    "quickstart": r"engines agree on all \d+ rules",
    "incremental_mining": r"batch 3: .* exact match",
    "corpus_pattern_mining": r"planted pattern recovered exactly",
    "count_server": r"incremental frequent set == full re-mine",
    "rule_server": r"append -> v2 .* still == host oracle",
    "streaming_bigdata": r"identical to uninterrupted run",
    "minority_report_census": r"identical across engines",
}


def _example_oracles(smi, rows=EXAMPLE_BIG_ROWS):
    """The 1M-row examples' host oracles timed apart, on their own data:
    what decides phase 20's cuts.  Not a phase: a script calls it before
    ``_examples`` (``build/phase20.py``, README)."""
    import numpy as np

    from repro_torch.core import (brute_force_counts, mine_frequent,
                                  minority_report)
    from repro_torch.core.incremental import ceil_count
    from repro_torch.data import bernoulli_db

    out = {}
    t = time.perf_counter()
    tx, y = bernoulli_db(rows, 40, p_x=0.15, p_y=0.03, seed=7)
    t1 = time.perf_counter()
    minority_report(tx, y, min_support=0.002, min_confidence=0.02)
    out["streaming_bigdata"] = dict(bernoulli_db_s=t1 - t,
                                    minority_report_s=time.perf_counter()
                                    - t1)
    del tx, y
    t = time.perf_counter()
    tx, _ = bernoulli_db(rows, 32, p_x=0.15, p_y=0.05, seed=3)
    t1 = time.perf_counter()
    _ = {a: sum(1 for r in tx if a in r) for a in range(32)}
    t2 = time.perf_counter()
    rng = np.random.default_rng(0)
    flat = sorted({tuple(rng.choice(32, size=k + 1, replace=False).tolist())
                   for k in rng.integers(0, 3, 24)})
    brute_force_counts(tx, flat)
    t3 = time.perf_counter()
    batch, _ = bernoulli_db(1000, 32, p_x=0.22, p_y=0.05, seed=9)
    mine_frequent([list(r) for r in tx] + [list(r) for r in batch],
                  ceil_count(0.06 * (rows + 1000)))
    out["count_server"] = dict(bernoulli_db_s=t1 - t, item_counts_s=t2 - t1,
                               brute_force_counts_s=t3 - t2,
                               mine_frequent_s=time.perf_counter() - t3)
    for name, parts in out.items():
        print(f"   {name} at {rows} rows, host oracle apart: "
              + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in parts.items())
              + f" [{smi}]", flush=True)
    return out


class _Tee(io.TextIOBase):
    """Writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        self.buf.write(text)
        return len(text)

    def flush(self):
        self.out.flush()


def _examples(dev, smi):
    """Phase 20: the examples on the card (see the module docstring).
    Returns each run's wall time, exactness line and launches, the launches
    summed, and the lint's two exits."""
    import runpy

    import torch

    from repro_torch.kernels.itemset_count import ops
    from repro_torch.roofline import autotune

    autotune.set_active_table(None)
    plain = [0]
    ref_blocked = ops.itemset_counts_ref_blocked

    def counted_plain(*args, **kwargs):
        plain[0] += 1
        return ref_blocked(*args, **kwargs)

    ops.itemset_counts_ref_blocked = counted_plain
    for cut in EXAMPLE_CUTS:
        print(f"   cut: {cut}", flush=True)
    argv = sys.argv
    runs = []
    for name, args in EXAMPLE_RUNS:
        path = ROOT / "examples" / "torch" / f"{name}.py"
        vpu0 = ops.KERNEL_LAUNCHES_BY_ACCUM["vpu_int32"]
        mxu0 = ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"]
        into0, plain0 = ops.KERNEL_LAUNCHES_INTO, plain[0]
        label = " ".join((name,) + tuple(args))
        print(f"   --- examples/torch/{name}.py {' '.join(args)} "
              f"--device {dev.type}", flush=True)
        sys.argv = [str(path), *args, "--device", dev.type]
        tee = _Tee(sys.stdout)
        t = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        sys.argv = argv
        into = ops.KERNEL_LAUNCHES_INTO - into0
        run = dict(example=label, wall_s=wall,
                   k1=ops.KERNEL_LAUNCHES_BY_ACCUM["vpu_int32"] - vpu0 - into,
                   k2=ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"] - mxu0,
                   k3=into, plain=plain[0] - plain0)
        exact = [ln for ln in tee.buf.getvalue().splitlines()
                 if re.search(EXAMPLE_EXACT[name], ln)]
        if not exact:
            raise AssertionError(f"{label}: no exactness line "
                                 f"/{EXAMPLE_EXACT[name]}/")
        run["exact"] = exact[-1].strip()
        if name not in EXAMPLE_HOST_ONLY and run["k1"] + run["k3"] == 0:
            raise AssertionError(f"{label}: neither K1 nor K3 launched")
        if run["plain"]:
            raise AssertionError(f"{label}: {run['plain']} counts went "
                                 "through the plain version")
        print(f"   {label}: {wall:.3f} s wall; \"{run['exact']}\"; launches "
              f"K1 {run['k1']}, K2 {run['k2']}, K3 {run['k3']}, plain "
              f"{run['plain']} [{smi}]", flush=True)
        runs.append(run)
    ops.itemset_counts_ref_blocked = ref_blocked

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    lint = {}
    for key, extra in (("self_test", ["--self-test"]), ("gate", [])):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.analyze", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        last = (out.stdout.strip().splitlines() or [""])[-1]
        print(f"   repro_torch.launch.analyze {' '.join(extra)}: exit "
              f"{out.returncode}: {last}", flush=True)
        if out.returncode != 0:
            raise AssertionError(f"the lint's {key} exited "
                                 f"{out.returncode}:\n{out.stdout}"
                                 f"{out.stderr}")
        lint[key] = last
    return dict(runs=runs, lint=lint,
                k1=sum(r["k1"] for r in runs), k2=sum(r["k2"] for r in runs),
                k3=sum(r["k3"] for r in runs))


def main() -> int:
    # phase 17 (d) runs under torch.use_deterministic_algorithms, which
    # wants cuBLAS's fixed workspace before the first handle exists
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.kernels.mra_encode import ops as encode_ops
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
    sources = (ops.SOURCE, ops.SOURCE_MXU, b1_probe.SOURCE,
               encode_ops.SOURCE)
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
    _encode_kernels_equal(tx_rows, y, items_kept, dev)
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

    def routes():
        snap = obs.snapshot()
        return {r: obs.counter_value(snap, "mra_encode_route_total", route=r)
                for r in ("device", "host")}

    def run(label, want_route, **kw):
        lv0 = levels_total()
        r0 = routes()
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
        route = ",".join(r for r, v in routes().items() if v > r0[r])
        if route != want_route:
            raise AssertionError(f"{label}: encode route {route!r}, expected "
                                 f"{want_route!r}")
        print(f"   {label}: {res.engine} engine, encode route {route}, "
              f"{len(res.rules)} rules, "
              f"{levels} levels, kernel launches measured {launches} "
              f"(result field {res.kernel_launches}; {into} of them "
              f"accumulate-into), "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        return res, launches, levels, into

    # the encode: on the card for the dense engine (the kernels of
    # kernels/mra_encode), numpy for a streamed pass 2 and the plain version
    dense, dense_launches, levels, _ = run("dense", "device")
    if dense_launches != levels + 1:     # every level, level 1 too, + fused
        raise AssertionError(f"dense: {dense_launches} launches, expected "
                             f"{levels} levels + 1")
    streamed, stream_launches, s_levels, into_launches = run(
        "streamed", "host", streaming=True, chunk_rows=STREAM_CHUNK_ROWS)
    if into_launches == 0:          # K3: the streamed sweep's launches
        raise AssertionError("the streamed main path launched no "
                             "accumulate-into kernel (K3)")
    if stream_launches != n_chunks * (s_levels + 1):
        raise AssertionError(f"streamed: {stream_launches} launches, "
                             f"expected {n_chunks} chunks x "
                             f"({s_levels} levels + 1)")
    plain, plain_launches, _, _ = run("plain version", "host",
                                      use_kernel=False)
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

    # ---- 12. the disk tier at the spill threshold ----------------------------
    t0 = _phase("12. disk tier at the spill threshold (untuned)")
    disk = _disk_tier(dev)
    _done(t0)

    # ---- 13. the mesh runtime on the one card --------------------------------
    t0 = _phase("13. mesh runtime on the one card (untuned)")
    dense_k1 = [itemset_counts(tx_d, tgt_d, w_d).cpu().numpy()
                for _, tgt_d in tgts]
    mesh_run = _mesh_runtime(dev, ub, uw, db.vocab, geoms, dense_k1,
                             want_freq, min_count)
    _done(t0)

    # ---- 14. the count server ------------------------------------------------
    t0 = _phase("14. count server at 1,000,000 rows (untuned)")
    serve = _count_server(dev, tx_rows, y, want_freq, per_launch[1]["ms"])
    _done(t0)

    # ---- 15. the rule server, the exporter, the lock watcher, the launcher ---
    t0 = _phase("15. rule server at 1,000,000 rows, exporter, lock watcher, "
                "serve_counts launcher (untuned)")
    print(f"   card: {smi}")
    rule = _rule_server(dev, tx_rows, y, dense.rules)
    _done(t0)

    # ---- 16. the model zoo's serving path --------------------------------
    t0 = _phase("16. model zoo serving path: 10 reduced archs (float32), "
                "qwen3-8b and mamba2-2.7b at full size (bf16)")
    print(f"   card: {smi}; allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    zoo = _model_zoo(dev, smi)
    _done(t0)

    # ---- 17. the training path ---------------------------------------------
    t0 = _phase("17. training: 10 reduced archs card vs host, loss, "
                "microbatches, bit-exact restart, launcher, data mesh; "
                "mamba2-2.7b and qwen3-8b (20 layers) at full width (bf16)")
    print(f"   card: {smi}; allocated at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    train = _training(dev, smi)
    _done(t0)

    # ---- 18. tensor and expert parallelism ---------------------------------
    t0 = _phase("18. tensor and expert parallelism: 10 reduced archs on "
                "(1, 2) and (2, 2); arctic-480b, llama4-maverick and "
                "qwen3-32b (full depth) serving and qwen3-8b training at "
                "full width on (1, 2) against (1, 1)")
    torch.cuda.empty_cache()
    print(f"   card: {smi}; allocated in this process at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    tensor_parallel = _tensor_parallel(smi)
    _done(t0)

    # ---- 19. the dry run against the card ----------------------------------
    t0 = _phase("19. the dry run against the card: five archs whole on 1 x 1 "
                "(FLOPs, argument bytes, peak, decode busy time against the "
                "count), qwen3-8b's collectives on (1, 2) gloo ranks")
    torch.cuda.empty_cache()
    print(f"   card: {smi}; allocated in this process at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)
    dry = _dry_run(dev, smi)
    _done(t0)

    # ---- 20. the examples ---------------------------------------------------
    t0 = _phase("20. the seven examples on the card (defaults; "
                f"streaming_bigdata at {EXAMPLE_STREAM_ROWS} rows streamed "
                f"and {EXAMPLE_BIG_ROWS} auto, count_server at "
                f"{EXAMPLE_BIG_ROWS}), the lint's self-test and gate")
    print(f"   card: {smi}", flush=True)
    examples = _examples(dev, smi)
    _done(t0)

    print(f"total seconds: {time.perf_counter() - t_all:.3f}")
    record = {"kernels": [{
        "name": "itemset_count",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/itemset_count.cu",
        "replaces": "src/repro/kernels/itemset_count/kernel.py:32",
        # the main path's run (phase 5) and the count server's (phase 14),
        # each read with the counts set to 0 just before it
        "launches": (dense_launches + serve["k1"] + rule["k1"]
                     + rule["launcher_k1"] + examples["k1"]),
        "launches_by_path": {"main path (phase 5)": dense_launches,
                             "count server (phase 14)": serve["k1"],
                             "rule server (phase 15)": rule["k1"],
                             "serve_counts launcher (phase 15)":
                             rule["launcher_k1"],
                             "examples (phase 20)": examples["k1"]},
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
        # phase 13: the mesh mine's launches on each rank of each mesh;
        # phase 14: the serving ranks' on mesh (2, 1)
        "launches_per_rank": dict(mesh_run["per_rank"], **{
            "(2, 1) gloo serving": serve["per_rank"]}),
        "per_launch": per_launch,
    }, {
        "name": "itemset_count_mxu",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/"
                  "itemset_count_mxu.cu",
        "replaces": "src/repro/kernels/itemset_count/kernel.py:53",
        # the tuned main path under the table pinned to mxu_f32 (phase 10)
        # and the count server's flushes under it (phase 14)
        "launches": mxu_routes["mxu_f32"] + serve["k2"],
        "launches_by_path": {"main path, pinned mxu_f32 (phase 10)":
                             mxu_routes["mxu_f32"],
                             "count server (phase 14)": serve["k2"]},
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
        # phase 12: the spilled mine under a table pinned to mxu_f32
        "launches_spilled": disk["launches_spilled_mxu"],
        "per_launch": per_launch_mxu,
    }, {
        "name": "itemset_count_into",
        "route": "cuda",
        "source": "src/repro_torch/kernels/itemset_count/csrc/"
                  "itemset_count.cu (accumulate = 1)",
        "replaces": "src/repro/kernels/itemset_count/ops.py:138",
        # the streamed main path (phase 5): 8 chunks a level; the count
        # server's streamed and spilled bases (phase 14)
        "launches": (into_launches + serve["k3"] + rule["k3"]
                     + rule["launcher_k3"] + examples["k3"]),
        "launches_by_path": {"streamed main path (phase 5)": into_launches,
                             "count server (phase 14)": serve["k3"],
                             "rule server (phase 15)": rule["k3"],
                             "serve_counts launcher (phase 15)":
                             rule["launcher_k3"],
                             "examples (phase 20)": examples["k3"]},
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
        # phase 12: the spilled mine, untuned (3 levels x the segments)
        "launches_spilled": disk["launches_spilled"],
        "spilled_sweeps": disk["sweeps"],
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"models": zoo}))
    print(json.dumps({"train": train}))
    print(json.dumps({"tensor_parallel": tensor_parallel}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
