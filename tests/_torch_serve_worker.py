"""One rank of a multi-process gloo run of the port's count server over a
mesh, for ``tests/test_torch_serving_mesh.py``.

The test spawns ``world`` processes on ``run``; each joins a gloo group
through a ``FileStore`` (never a fixed TCP port), builds a ``(world, 1)``
mesh, runs ``serve`` on the same inputs and in the same order as every
other rank (the mesh path is SPMD), and pickles what it saw to
``out_dir/rank<r>.pkl`` (a traceback to ``rank<r>.err`` on failure, then a
non-zero exit).  ``rules`` then runs the rule server over the same mesh.  Imports the port only, so a rank starts without JAX.
"""
import datetime
import os
import pickle
import traceback

TIMEOUT_S = 60


def run(rank: int, world: int, store: str, payload_path: str,
        out_dir: str) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            with open(payload_path, "rb") as f:
                payload = pickle.load(f)
            from repro_torch.launch.mesh import make_host_mesh

            mesh = make_host_mesh(world, 1, device_type="cpu")
            out = serve(mesh, payload, world)
            out["rules"] = rules(mesh, payload["rules"])
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class _CountingAllReduce:
    """Counts the all-reduces made inside the block."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.inner = dist.all_reduce
        self.calls = 0

    def __enter__(self):
        def counted(tensor, *args, **kwargs):
            self.calls += 1
            return self.inner(tensor, *args, **kwargs)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.inner


def serve(mesh, p, world):
    """The sharded store and the count server over the mesh: counts before
    and after appends that widen W, one all-reduce per flush, the rows this
    rank holds, the server's flushes, mine and maintained frequent set, and
    whether ``async_flush`` was refused."""
    from repro_torch.serve import CountServer, ShardedDB

    out = {"coord": mesh.get_coordinate(), "size": mesh.size()}
    sharded = ShardedDB(p["tx"], classes=p["y"], n_classes=2,
                        n_shards=p["n_shards"], mesh=mesh, merge_ratio=1e9,
                        device="cpu")
    with _CountingAllReduce() as ar:
        out["counts"] = [sharded.counts(p["probes"])]
    out["reduces"] = [ar.calls]
    out["rows_held"] = [int(sharded._mesh_resident[0].shape[0])]
    for batch, yb in zip(p["batches"], p["batch_y"]):
        sharded.append(batch, classes=yb)
        with _CountingAllReduce() as ar:
            out["counts"].append(sharded.counts(p["probes_after"]))
        out["reduces"].append(ar.calls)
        out["rows_held"].append(int(sharded._mesh_resident[0].shape[0]))
    out["width"] = int(sharded._mesh_resident[0].shape[1])
    out["stats"] = {k: v for k, v in sharded.stats().items()
                    if k in ("version", "n_rows", "mesh", "n_shards",
                             "kernel_launches", "resident")}

    srv = CountServer(p["tx"], classes=p["y"], n_classes=2,
                      shards=p["n_shards"], mesh=mesh, block_k=8,
                      device="cpu")
    tickets = [srv.submit(f"c{i}", r) for i, r in enumerate(p["requests"])]
    with _CountingAllReduce() as ar:
        res = srv.flush()
    out["flush"] = [res[t] for t in tickets]
    out["flush_reduces"] = ar.calls
    out["mine"] = srv.mine(p["theta"])
    srv.append(p["batches"][0], classes=p["batch_y"][0])
    out["frequent"] = srv.frequent
    out["query"] = srv.query(p["probes_after"])

    try:
        asrv = CountServer(p["tx"], classes=p["y"], n_classes=2,
                           shards=p["n_shards"], mesh=mesh,
                           async_flush=True, max_delay_ms=5, device="cpu")
    except ValueError as e:
        out["async_refused"] = str(e)
        return out
    out["async_refused"] = None
    try:        # one rank: the flusher thread's all-reduce needs no partner
        out["async"] = asrv.submit_async("a", p["requests"][0]).result(30)
    finally:
        asrv.close()
    return out


def rules(mesh, r):
    """The rule server over a sharded server on the mesh, through the
    reference's mesh battery: per round (the initial rows and two appends
    that widen the vocab), the complete rule list of ``top_rules``, its
    optimal set and ``rules_for`` of its antecedents, as tuples."""
    from dataclasses import astuple

    from repro_torch.serve import CountServer, RuleServer

    ruler = RuleServer(CountServer(r["tx"], classes=r["y"], n_classes=2,
                                   shards=r["n_shards"], mesh=mesh,
                                   device="cpu"))
    out = []
    for rnd in range(len(r["batches"]) + 1):
        top = ruler.top_rules(r["theta"], r["min_conf"])
        out.append({
            "top": [astuple(x) for x in top],
            "optimal": [astuple(x) for x in ruler.top_rules(
                r["theta"], r["min_conf"], optimal=True)],
            "rules_for": [astuple(x) for x in ruler.rules_for(
                [x.antecedent for x in top], min_conf=r["min_conf"])],
            "launches": ruler.server.store.kernel_launches,
        })
        if rnd < len(r["batches"]):
            ruler.append(r["batches"][rnd], classes=r["batch_y"][rnd])
    return out
