"""Online count-serving demo — the GFP count server end to end.

The paper's multitude-targeted contract ("the count of a given large list of
itemsets") as an online service: an encoded DB stays RESIDENT between
requests, many small client queries are coalesced into one guided counting
pass, repeated queries hit an (itemset, version) cache, and appended
transaction batches are folded in incrementally (§5.2) without re-encoding
the history.

Serving API (submit / flush):

    server = CountServer(transactions, classes=y)    # encode once, keep resident
    t1 = server.submit("client-a", [(2, 5), (7,)])   # queue queries (a ticket each)
    t2 = server.submit("client-b", [(5, 2)])         # same target: deduped across clients
    results = server.flush()                         # ONE batched counting pass
    results[t1]    # (2, C) int32 rows, aligned with client-a's submission order
    results[t2]    # (1, C) — bit-identical to client-a's (2, 5) row
    server.query([(2, 5)])                           # submit+flush shorthand

    server.append(new_tx, classes=new_y)             # version += 1 (cache invalidated)
    server.mine(theta)                               # exact frequent set, engine-mined
    server.append(more_tx, classes=more_y)           # ... maintained via §5.2 pigeonhole
    server.frequent                                  #     candidates + one guided recount

The server counts on ``--device`` (default: the card).

  PYTHONPATH=src python examples/torch/count_server.py [rows] [append_rows] \
      [--device cuda|cpu]
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import ItemOrder, TISTree, brute_force_counts
from repro_torch.data import bernoulli_db
from repro_torch.mining import DenseDB, dense_gfp_counts
from repro_torch.serve import CountServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", nargs="?", type=int, default=8000)
    ap.add_argument("append_rows", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rows, append_rows = args.rows, args.append_rows

    tx, y = bernoulli_db(rows, 32, p_x=0.15, p_y=0.05, seed=3)
    server = CountServer(tx, classes=list(y), device=device)
    st = server.store
    print(f"resident {st.resident} DB: {st.base_rows} unique rows of "
          f"{st.n_rows}, {st.vocab.size} items, version {st.version}")

    # ---- micro-batched serving: many clients, one counting pass ------------
    rng = np.random.default_rng(0)
    queries = {f"client-{c}": [tuple(rng.choice(32, size=k + 1,
                                                replace=False).tolist())
                               for k in rng.integers(0, 3, 6)]
               for c in range(4)}
    tickets = {c: server.submit(c, qs) for c, qs in queries.items()}
    t0 = time.time()
    results = server.flush()
    n_q = sum(len(qs) for qs in queries.values())
    print(f"flushed {n_q} queries from {len(queries)} clients in one pass "
          f"({1e3 * (time.time() - t0):.1f} ms, "
          f"{server.store.kernel_launches} launches, "
          f"{server.batcher.n_deduped} deduped)")

    # exactness: identical to the GFP-growth contract on a fresh dense encode
    counts = {a: sum(1 for t in tx if a in t) for a in range(32)}
    tis = TISTree(ItemOrder.from_counts(counts))
    flat = sorted({k for qs in queries.values() for k in qs})
    for k in flat:
        tis.insert(list(k), target=True)
    gfp = dense_gfp_counts(tis, DenseDB.encode(tx, classes=list(y),
                                               n_classes=2, device=device))
    for client, qs in queries.items():
        for i, k in enumerate(qs):
            key = tuple(sorted(set(k), key=repr))
            assert (results[tickets[client]][i] == gfp[key]).all()
    oracle = brute_force_counts(tx, flat)
    assert all(int(gfp[key].sum()) == oracle[key]
               for key in (tuple(sorted(set(k), key=repr)) for k in flat))
    print(f"all {n_q} served rows bit-identical to dense_gfp_counts "
          f"(+ brute-force oracle) at v{server.store.version}")

    # ---- hot queries: the (itemset, version) cache -------------------------
    hot = flat[:8]
    server.query(hot)                       # warm
    t0 = time.time()
    server.query(hot)                       # all hits: no device work
    t_hot = time.time() - t0
    print(f"hot repeat of {len(hot)} queries: {1e6 * t_hot:.0f} us "
          f"(cache hit rate {server.cache.hit_rate:.2f})")

    # ---- growth: appends bump the version and refresh the frequent set -----
    theta = 0.06
    freq = server.mine(theta)
    print(f"mined {len(freq)} frequent itemsets at theta={theta}")
    before = server.query(hot)
    batch, yb = bernoulli_db(append_rows, 32, p_x=0.22, p_y=0.05, seed=9)
    v = server.append(batch, classes=list(yb))
    after = server.query(hot)               # version changed: cache misses
    changed = int((before != after).any(axis=1).sum())
    print(f"append -> v{v} (+{append_rows} rows): {changed}/{len(hot)} hot "
          f"counts changed, frequent set -> {len(server.frequent)} "
          f"(engine-recounted §5.2 candidates)")

    from repro_torch.core import mine_frequent
    from repro_torch.core.incremental import ceil_count
    full = mine_frequent([list(t) for t in tx] + [list(t) for t in batch],
                         ceil_count(theta * (rows + append_rows)))
    assert server.frequent == full
    print(f"incremental frequent set == full re-mine ({len(full)} itemsets)")


if __name__ == "__main__":
    main()
