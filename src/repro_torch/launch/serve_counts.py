"""Count-serving launcher — drive the GFP count server with a query workload.

  PYTHONPATH=src python -m repro_torch.launch.serve_counts --rows 20000 \
      --items 40 --clients 8 --rounds 16 --batch 32 --appends 2 --verify

Builds a synthetic transaction DB, keeps it resident in a ``CountServer``
(device-dense or host-streaming by size) on ``--device`` (default: the
card, which raises without one; ``cpu`` runs the plain PyTorch counting on
the host), and serves rounds of micro-batched itemset-count queries from
simulated clients — with optional mid-run appends (version bumps + cache
invalidation) and ``--theta`` incremental re-mining.  ``--verify``
cross-checks every distinct served key against a fresh dense encode of the
full history at the final version, counted by ``itemset_counts`` on the
same device (bit-identical or it dies).

``--shards N`` row-partitions the store over N ``VersionedDB`` shards.
``--mesh-data D`` additionally lays them out over a ``torch.distributed``
``DeviceMesh`` of D ranks (``launch/mesh.py::make_host_mesh``): the
launcher joins the process group that ``torchrun`` describes in the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
with no such group and D = 1 it makes a one-rank group itself (NCCL on the
card, gloo on the CPU); D > 1 needs ``torchrun --nproc-per-node D``.  Every
rank runs the same seeded traffic (the mesh path is SPMD) and rank 0
prints.  ``--async-flush`` serves through the background flush loop
(``--max-delay-ms`` / ``--min-batch`` triggers): requests are submitted as
futures and the flush-latency distribution is reported at the end.  It is
refused over more than one rank: each rank's flusher would pick its own
flush times.

``--rules`` layers a ``RuleServer`` on top: every round additionally serves
minority-rule queries (antecedent -> ``--target-class`` at ``--min-conf``)
from the same pool through the rule cache, appends go through the rule
server (stale-verdict purge + hottest-key prefetch), and with ``--theta``
the run ends with a resumable ``top_rules`` sweep.  ``--verify`` then also
cross-checks every served rule — and the top_rules list — against the host
``minority_report`` / ``optimal_rule_set`` oracle on the full history.

The run ends with the kernel wrapper's launch counters by route (0 on the
CPU, where the plain version counts) and the telemetry summary line.
"""
import argparse
import os
import sys
import time
from typing import Optional, Sequence


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--items", type=int, default=40)
    ap.add_argument("--p-x", type=float, default=0.15)
    ap.add_argument("--p-y", type=float, default=0.05)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=16,
                    help="flush rounds; each round submits --batch requests")
    ap.add_argument("--batch", type=int, default=32,
                    help="requests coalesced per flush (micro-batch size)")
    ap.add_argument("--targets-per-query", type=int, default=2)
    ap.add_argument("--max-itemset-len", type=int, default=3)
    ap.add_argument("--pool", type=int, default=128,
                    help="distinct query pool size (repeats exercise the "
                         "cache)")
    ap.add_argument("--appends", type=int, default=0,
                    help="mid-run append batches (version bumps)")
    ap.add_argument("--append-rows", type=int, default=1000)
    ap.add_argument("--theta", type=float, default=None,
                    help="maintain the frequent set incrementally at theta")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--cache-size", type=int, default=65536)
    ap.add_argument("--block-k", type=int, default=None,
                    help="serve K-pad block (default: per-device tuning "
                         "table, else 256)")
    ap.add_argument("--spill-dir", default=None, metavar="DIR",
                    help="disk-tier root: spill the base past the budget "
                         "(default $REPRO_TORCH_SPILL_DIR)")
    ap.add_argument("--spill-threshold-bytes", type=int, default=None,
                    help="host-RAM budget before the base spills to disk")
    ap.add_argument("--bg-compact", action="store_true",
                    help="fold deltas on a background compactor thread "
                         "instead of inline in append()")
    ap.add_argument("--min-compact-rows", type=int, default=None,
                    help="auto-compaction floor (delta rows)")
    ap.add_argument("--streaming", action="store_true",
                    help="force the host-resident streaming backend")
    ap.add_argument("--chunk-rows", type=int, default=None)
    ap.add_argument("--shards", type=int, default=None,
                    help="row-partition the store over N shards")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="lay the shards over a torch.distributed mesh of D "
                         "ranks (D > 1: launch with torchrun)")
    ap.add_argument("--async-flush", action="store_true",
                    help="serve through the background flush loop")
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--min-batch", type=int, default=8)
    ap.add_argument("--rules", action="store_true",
                    help="serve minority rules over the count path")
    ap.add_argument("--min-conf", type=float, default=0.3)
    ap.add_argument("--target-class", type=int, default=1)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus text) and /metrics.json "
                         "on this port for the run's duration (0=ephemeral)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the final registry snapshot as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable span tracing; write a Chrome trace_event "
                         "JSON dump (chrome://tracing / Perfetto) and print "
                         "the per-span summary on exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _join_mesh(data: int, device):
    """A ``(data, 1)`` mesh over the process group: the one ``torchrun``
    describes in the environment, else a one-rank group made here (only for
    ``data == 1``).  Returns ``(mesh, made_group)``."""
    import torch.distributed as dist

    from .mesh import make_host_mesh

    made = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        elif data == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise SystemExit(
                f"--mesh-data {data} needs {data} ranks: launch with "
                f"torchrun --nproc-per-node {data} -m "
                "repro_torch.launch.serve_counts ...")
        made = True
    try:
        return make_host_mesh(data, 1, device_type=device.type), made
    except ValueError as e:
        if made:
            dist.destroy_process_group()
        raise SystemExit(f"--mesh-data {data}: {e}") from e


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parse(argv)

    from .._device import resolve_device

    device = resolve_device(args.device)
    mesh, made_group = None, False
    rank = 0
    if args.mesh_data is not None:
        if args.shards is None:
            raise SystemExit("--mesh-data requires --shards")
        mesh, made_group = _join_mesh(args.mesh_data, device)
        import torch.distributed as dist

        rank = dist.get_rank()
        if args.async_flush and dist.get_world_size() > 1:
            dist.destroy_process_group()
            raise SystemExit(
                "--async-flush over more than one rank: each rank's flusher "
                "would pick its own flush times and the ranks' all-reduces "
                "would pair different batches; flush synchronously")
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        _serve(args, device, mesh, say)
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, device, mesh, say) -> None:
    import numpy as np

    from .. import obs
    from ..data import bernoulli_db
    from ..kernels.itemset_count import ops
    from ..serve import CountServer

    if args.trace:
        obs.configure(tracing=True)
    metrics_srv = None
    if args.metrics_port is not None:
        from ..obs.export import start_metrics_server

        metrics_srv = start_metrics_server(args.metrics_port)
        say(f"metrics: http://127.0.0.1:"
            f"{metrics_srv.server_address[1]}/metrics")

    tx, y = bernoulli_db(args.rows, args.items, args.p_x, args.p_y, args.seed)
    server = CountServer(
        tx, classes=list(y), use_kernel=True,
        streaming=True if args.streaming else None,
        chunk_rows=args.chunk_rows, cache=not args.no_cache,
        cache_size=args.cache_size, block_k=args.block_k,
        min_compact_rows=args.min_compact_rows, spill_dir=args.spill_dir,
        spill_threshold_bytes=args.spill_threshold_bytes,
        background_compaction=args.bg_compact,
        shards=args.shards, mesh=mesh, async_flush=args.async_flush,
        max_delay_ms=args.max_delay_ms, min_batch=args.min_batch,
        device=device)
    st = server.store
    say(f"resident: {st.resident} DB, {st.base_rows} unique rows "
        f"(of {st.n_rows}), {st.vocab.size} items, v{st.version}; "
        f"device {device}")
    from ..roofline import autotune
    say(f"autotune: {autotune.describe_active()} "
        f"(block_k={server.batcher.block_k})")
    ruler = None
    if args.rules:
        from ..serve import RuleServer

        ruler = RuleServer(server, target_class=args.target_class,
                           cache=not args.no_cache)
    if args.theta is not None:
        t0 = time.time()
        freq = server.mine(args.theta)
        say(f"mined {len(freq)} frequent itemsets at theta={args.theta} "
            f"({time.time() - t0:.2f}s)")

    rng = np.random.default_rng(args.seed + 1)
    pool = [tuple(rng.choice(args.items,
                             size=rng.integers(1, args.max_itemset_len + 1),
                             replace=False).tolist())
            for _ in range(args.pool)]
    # spread appends over rounds 1..rounds-1 without collapsing: linspace
    # over the ROUND INDICES keeps every pick distinct (spacing >= 1) and
    # caps the count at the available rounds
    avail = list(range(1, args.rounds))
    n_app = min(args.appends, len(avail))
    append_at = ({avail[i] for i in
                  np.linspace(0, len(avail) - 1, n_app).round().astype(int)}
                 if n_app > 0 else set())
    if len(append_at) < args.appends:
        say(f"note: only {len(append_at)} append rounds fit in "
            f"--rounds {args.rounds}")

    n_queries = 0
    n_rule_queries = 0
    t_serve = 0.0
    t_rules = 0.0
    for rnd in range(args.rounds):
        if rnd in append_at:
            batch, yb = bernoulli_db(args.append_rows, args.items, args.p_x,
                                     args.p_y, args.seed + 100 + rnd)
            t0 = time.time()
            appender = server if ruler is None else ruler
            v = appender.append(batch, classes=list(yb))
            msg = f"append #{v}: +{len(batch)} rows ({time.time()-t0:.2f}s)"
            if args.theta is not None:
                msg += f", frequent set -> {len(server.frequent)}"
            say(msg)
        t0 = time.time()
        futures = []
        for b in range(args.batch):
            client = f"client-{(rnd * args.batch + b) % args.clients}"
            picks = rng.integers(0, len(pool), args.targets_per_query)
            request = [pool[i] for i in picks]
            if args.async_flush:
                futures.append(server.submit_async(client, request))
            else:
                server.submit(client, request)
            n_queries += args.targets_per_query
        if args.async_flush:
            for fut in futures:
                fut.result(timeout=60)   # background loop answers the round
        else:
            server.flush()
        t_serve += time.time() - t0
        if ruler is not None:            # rule traffic rides the same pool,
            t0 = time.time()             # timed on its own clock
            picks = rng.integers(0, len(pool), args.batch)
            ruler.rules_for([pool[i] for i in picks],
                            min_conf=args.min_conf)
            t_rules += time.time() - t0
            n_rule_queries += args.batch
    server.close()                        # drains any still-pending tickets

    us_q = 1e6 * t_serve / max(1, n_queries)
    say(f"served {n_queries} queries in {args.rounds} rounds: "
        f"{us_q:.1f} us/query, {n_queries / max(t_serve, 1e-9):,.0f} q/s")
    s = server.stats()
    if s["async"] is not None:
        a = s["async"]
        lat = a["flush_latency_ms"]
        say(f"async: {a['flushes']} flushes {a['by_trigger']}, "
            f"{a['flush_errors']} errors, flush latency "
            f"p50={lat['p50']:.1f}ms p95={lat['p95']:.1f}ms "
            f"max={lat['max']:.1f}ms (budget {a['max_delay_ms']:.0f}ms)")
    cache = s["cache"]
    cache_msg = ("cache off" if cache is None else
                 f"cache hit rate {cache['hit_rate']:.2f} "
                 f"({cache['hits']} hits)")
    say(f"batcher deduped {s['batcher']['deduped']}/"
        f"{s['batcher']['queries']} queries; {cache_msg}; "
        f"{s['store']['kernel_launches']} kernel launches")
    top = None
    if ruler is not None:
        rst = ruler.stats()
        rc = rst["rule_cache"]
        rc_msg = ("rule cache off" if rc is None else
                  f"rule cache hit rate {rc['hit_rate']:.2f} "
                  f"({rc['hits']} hits)")
        us_r = 1e6 * t_rules / max(1, n_rule_queries)
        say(f"rules: {rst['rule_queries']} rule queries "
            f"({us_r:.1f} us/rule-query), {rst['prefetches']} prefetch "
            f"rounds ({rst['prefetched_keys']} keys re-warmed); {rc_msg}")
        if args.theta is not None:
            t0 = time.time()
            top = ruler.top_rules(args.theta, args.min_conf, optimal=True)
            say(f"top_rules(theta={args.theta}, "
                f"min_conf={args.min_conf}): {len(top)} optimal rules "
                f"({time.time() - t0:.2f}s)")
            for r in top[:3]:
                say(f"  {r}")

    if args.verify:
        _verify(args, server, ruler, top, tx, y, pool, append_at, device,
                say)

    snap = obs.snapshot()
    if args.metrics_dump:
        from ..obs.export import dump_json

        dump_json(args.metrics_dump, snap,
                  extra={"kernel_efficiency": obs.kernel_efficiency(snap)})
        say(f"metrics snapshot -> {args.metrics_dump}")
    if args.trace:
        import json

        with open(args.trace, "w") as f:
            json.dump(obs.TRACER.chrome_trace(), f)
        say(f"chrome trace ({len(obs.TRACER.spans())} spans) -> "
            f"{args.trace}")
        say(obs.TRACER.summary())
    if metrics_srv is not None:
        metrics_srv.shutdown()
    say(f"kernel launches by route: {ops.KERNEL_LAUNCHES} "
        f"(vpu_int32 {ops.KERNEL_LAUNCHES_BY_ACCUM['vpu_int32']}, "
        f"mxu_f32 {ops.KERNEL_LAUNCHES_BY_ACCUM['mxu_f32']}; "
        f"accumulate-into {ops.KERNEL_LAUNCHES_INTO})")
    say(obs.summary_line(snap))


def _verify(args, server, ruler, top, tx, y, pool, append_at, device,
            say) -> None:
    """Served keys against a fresh dense encode of the whole history
    counted on ``device``; served rules against those rows; with
    ``--theta``, ``top_rules`` against the host oracle."""
    import torch

    from ..data import bernoulli_db
    from ..kernels.itemset_count import itemset_counts
    from ..mining import DenseDB, encode_targets

    # rebuild the full history exactly as served
    all_tx = [list(t) for t in tx]
    all_y = list(y)
    for rnd in sorted(append_at):
        batch, yb = bernoulli_db(args.append_rows, args.items, args.p_x,
                                 args.p_y, args.seed + 100 + rnd)
        all_tx += [list(t) for t in batch]
        all_y += list(yb)
    ddb = DenseDB.encode(all_tx, classes=all_y,
                         n_classes=server.store.n_classes, device=device)
    keys = [k for k in pool if all(a in ddb.vocab for a in k)]
    got = server.query(keys)
    want = itemset_counts(
        ddb.bits, torch.from_numpy(encode_targets(keys, ddb.vocab)).to(device),
        ddb.weights).cpu().numpy()
    assert (got == want).all(), "served counts != fresh dense"
    say(f"verified {len(keys)} keys bit-identical to a fresh dense "
        f"encode at v{server.store.version}")
    if ruler is None:
        return
    # served rule verdicts vs the independently counted fresh rows
    served = ruler.rules_for(keys, min_conf=args.min_conf)
    n_db = server.store.n_rows
    for key, row, rule in zip(keys, want, served):
        key = tuple(sorted(set(key), key=repr))
        cnt = int(row[args.target_class])
        gcnt = int(row.sum()) - cnt
        conf = cnt / (cnt + gcnt) if (cnt + gcnt) else 0.0
        if conf >= args.min_conf:
            assert rule is not None and rule.count == cnt \
                and rule.g_count == gcnt \
                and rule.confidence == conf \
                and rule.support == cnt / n_db, key
        else:
            assert rule is None, key
    if args.theta is not None:
        from ..core import minority_report, optimal_rule_set

        res = minority_report(
            all_tx, all_y, target_class=args.target_class,
            min_support=args.theta, min_confidence=args.min_conf)
        assert ruler.top_rules(args.theta, args.min_conf) \
            == res.rules, "served rule set != host minority_report"
        assert top == optimal_rule_set(res.rules), \
            "served optimal set != host optimal_rule_set"
        say(f"verified {len(res.rules)} rules "
            f"({len(top)} optimal) == host minority_report "
            f"oracle at v{server.store.version}")


if __name__ == "__main__":
    main(sys.argv[1:])
