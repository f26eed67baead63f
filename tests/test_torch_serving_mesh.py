"""The port's count server over a ``torch.distributed`` mesh, in several
processes: gloo groups on the CPU, on meshes (1, 1), (2, 1) and (4, 1),
each rank running ``tests/_torch_serve_worker.py`` on the same inputs (the
mesh path is SPMD).  ``ShardedDB(mesh=)`` and ``CountServer(shards=,
mesh=)`` on every rank equal the JAX package's on its in-process mesh,
integer for integer, before and after appends that widen W; one all-reduce
per flush; each rank holds only its block of rows; ``async_flush`` is
refused over more than one rank and works on one.  The rule server over
the sharded mesh server equals the JAX package's host oracle (the
reference's slow mesh rule case).

One module fixture spawns the three groups at once, each rendezvousing
through a ``FileStore`` under the test's temporary directory, with a
timeout on the group and a deadline on the join."""
import os
import pickle

import numpy as np
import pytest
import torch.multiprocessing as tmp

import _torch_serve_worker as worker
import repro.serve as js
from repro.core import mine_frequent
from repro.core.incremental import ceil_count

JOIN_S = 120
WORLDS = (1, 2, 4)
N_SHARDS = 3


def _problem():
    rng = np.random.default_rng(51)

    def db(rows, items, p=0.3):
        return [[int(a) for a in range(items) if rng.random() < p]
                for _ in range(rows)]

    tx = db(400, 40)
    y = [int(rng.random() < 0.4) for _ in tx]
    batches = [db(80, 40 + 30 * step) for step in (1, 2)]   # W 2 -> 4 words
    batch_y = [[int(rng.random() < 0.4) for _ in b] for b in batches]
    probes = [(0, 1), (2,), (3, 7, 39), (11,), ("nope",)]
    return dict(tx=tx, y=y, batches=batches, batch_y=batch_y, probes=probes,
                rules=_rules_problem(),
                probes_after=probes + [(41,), (0, 45), (95,), (2, 99)],
                requests=[[(0, 1), (2,), (1, 0)], [(0, 1), (5, 6, 7)],
                          [(39,), ("nope",)]],
                n_shards=N_SHARDS, theta=0.15)


def _rules_problem():
    """The reference's slow mesh rule case (``tests/test_rule_serving.py``):
    300 rows of 24 items, two appends of 120 rows widening to 28 and 32
    items, theta 0.04, min_conf 0.36, four shards."""
    rng = np.random.default_rng(61)

    def db(rows, items, p=0.3):
        return [[int(a) for a in range(items) if rng.random() < p]
                for _ in range(rows)]

    tx = db(300, 24)
    y = [int(rng.random() < 0.35) for _ in tx]
    batches, batch_y = [], []
    for rnd in range(2):
        batches.append(db(120, 24 + 4 * rnd))
        batch_y.append([int(rng.random() < 0.35) for _ in batches[-1]])
    return dict(tx=tx, y=y, batches=batches, batch_y=batch_y, theta=0.04,
                min_conf=0.36, n_shards=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve_mesh")
    p = _problem()
    pay = str(base / "payload.pkl")
    with open(pay, "wb") as f:
        pickle.dump(p, f)
    ctx = tmp.get_context("spawn")
    procs = {}
    for world in WORLDS:
        d = base / f"w{world}"
        d.mkdir()
        procs[world] = [ctx.Process(target=worker.run, daemon=True, args=(
            r, world, str(d / "store"), pay, str(d))) for r in range(world)]
    for ps in procs.values():
        for q in ps:
            q.start()
    try:
        for ps in procs.values():
            for q in ps:
                q.join(JOIN_S)
    finally:
        hung = [q for ps in procs.values() for q in ps if q.is_alive()]
        for q in hung:
            q.kill()
            q.join(10)
    out = {}
    for world, ps in procs.items():
        d = base / f"w{world}"
        errs = {r: open(str(d / f"rank{r}.err")).read()
                for r in range(world)
                if os.path.exists(str(d / f"rank{r}.err"))}
        assert not hung, f"ranks still running after {JOIN_S} s: {errs}"
        assert [q.exitcode for q in ps] == [0] * world, errs
        out[world] = [pickle.load(open(str(d / f"rank{r}.pkl"), "rb"))
                      for r in range(world)]
    return dict(p=p, out=out)


@pytest.fixture(scope="module")
def jax_results(runs):
    """The JAX package's sharded store and server on its in-process mesh
    of one device, the same calls in the same order."""
    import jax

    p = runs["p"]
    mesh = jax.make_mesh((1,), ("data",))
    sharded = js.ShardedDB(p["tx"], classes=p["y"], n_classes=2,
                           n_shards=N_SHARDS, mesh=mesh, merge_ratio=1e9)
    single = js.VersionedDB(p["tx"], classes=p["y"], n_classes=2,
                            merge_ratio=1e9)
    counts = [sharded.counts(p["probes"])]
    np.testing.assert_array_equal(counts[0], single.counts(p["probes"]))
    for batch, yb in zip(p["batches"], p["batch_y"]):
        sharded.append(batch, classes=yb)
        single.append(batch, classes=yb)
        counts.append(sharded.counts(p["probes_after"]))
        np.testing.assert_array_equal(counts[-1],
                                      single.counts(p["probes_after"]))
    srv = js.CountServer(p["tx"], classes=p["y"], n_classes=2,
                         shards=N_SHARDS, mesh=mesh, block_k=8)
    tickets = [srv.submit(f"c{i}", r) for i, r in enumerate(p["requests"])]
    res = srv.flush()
    flush = [res[t] for t in tickets]
    mine = srv.mine(p["theta"])
    srv.append(p["batches"][0], classes=p["batch_y"][0])
    return dict(counts=counts, stats=sharded.stats(), flush=flush, mine=mine,
                frequent=srv.frequent, query=srv.query(p["probes_after"]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_counts_match_jax_on_every_rank(runs, jax_results, world):
    """Before and after appends that widen W past two word boundaries."""
    want = jax_results["counts"]
    for o in runs["out"][world]:
        assert len(o["counts"]) == len(want) == 3
        for got, w in zip(o["counts"], want):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, w)
        assert o["width"] == 4


@pytest.mark.parametrize("world", WORLDS)
def test_one_all_reduce_per_flush_and_rows_per_rank(runs, world):
    """One world all-reduce per counting call; each rank holds its block of
    the stacked rows, padded to the data-axis multiple."""
    for o in runs["out"][world]:
        assert o["size"] == world
        assert o["reduces"] == [1, 1, 1]
        assert o["flush_reduces"] == 1
    held = [o["rows_held"] for o in runs["out"][world]]
    assert all(h == held[0] for h in held)       # one height on every rank
    if world > 1:
        one = runs["out"][1][0]["rows_held"]
        assert held[0] == [-(-n // world) for n in one]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stats_report_the_data_axis(runs, jax_results, world):
    want = jax_results["stats"]
    for o in runs["out"][world]:
        st = o["stats"]
        assert st["mesh"] == {"data": world}
        for key in ("version", "n_rows", "n_shards", "kernel_launches",
                    "resident"):
            assert st[key] == want[key], key
    assert want["mesh"] == {"data": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_server_over_the_mesh_matches_jax(runs, jax_results, world):
    """CountServer(shards=, mesh=): flushed blocks, the mine, the frequent
    set maintained over an append, and a query after it."""
    p = runs["p"]
    want_mine = mine_frequent(p["tx"], ceil_count(p["theta"] * len(p["tx"])))
    assert jax_results["mine"] == want_mine
    for o in runs["out"][world]:
        for got, w in zip(o["flush"], jax_results["flush"]):
            np.testing.assert_array_equal(got, w)
        assert o["mine"] == want_mine
        assert o["frequent"] == jax_results["frequent"]
        np.testing.assert_array_equal(o["query"], jax_results["query"])


@pytest.mark.parametrize("world", WORLDS)
def test_async_flush_refused_over_more_than_one_rank(runs, jax_results,
                                                     world):
    """A deliberate difference from the JAX package: each rank's flusher
    would pick its own flush times, so async flush over a mesh of more than
    one rank is refused; on one rank it serves."""
    for o in runs["out"][world]:
        if world == 1:
            assert o["async_refused"] is None
            np.testing.assert_array_equal(o["async"],
                                          jax_results["flush"][0])
        else:
            assert "async_flush over a mesh" in o["async_refused"]


@pytest.mark.parametrize("world", WORLDS)
def test_rule_server_over_the_mesh_matches_host_oracle(runs, world):
    """The reference's slow mesh rule case on gloo meshes: every round's
    ``top_rules``, optimal set and ``rules_for`` equal the JAX package's
    host ``minority_report`` / ``optimal_rule_set`` field for field, on
    every rank."""
    from dataclasses import astuple

    from repro.core import minority_report, optimal_rule_set

    r = runs["p"]["rules"]
    hist, ys = [list(t) for t in r["tx"]], list(r["y"])
    want = []
    for rnd in range(3):
        res = minority_report(hist, ys, target_class=1,
                              min_support=r["theta"],
                              min_confidence=r["min_conf"])
        assert res.rules, "oracle mined no rules"
        want.append(([astuple(x) for x in res.rules],
                     [astuple(x) for x in optimal_rule_set(res.rules)]))
        if rnd < 2:
            hist += [list(t) for t in r["batches"][rnd]]
            ys += r["batch_y"][rnd]
    for o in runs["out"][world]:
        assert len(o["rules"]) == 3
        for got, (top, optimal) in zip(o["rules"], want):
            assert got["top"] == top
            assert got["optimal"] == optimal
            assert got["rules_for"] == top
        assert o["rules"][-1]["launches"] > 0
