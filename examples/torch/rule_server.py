"""Online minority-rule serving demo — MRA rules over the count path.

The paper's headline application (Algorithm 4.1) as an online service:
``RuleServer`` layers minority-class rules (antecedent -> class, confidence
= C1/(C1+C0)) on the resident count server.  Rule queries ride the same
micro-batched counting path; a rule cache keyed on (antecedent, version,
min_conf) answers hot keys without touching the device; appends purge stale
verdicts and PREFETCH the hottest keys at the new version; and
``top_rules`` runs the full §5.1 workload — class-guided resumable mining +
``optimal_rule_set`` filtering — against the live store.

Serving API:

    ruler = RuleServer(CountServer(tx, classes=y))
    ruler.rules_for([(2, 5), (7,)], min_conf=0.3)   # verdicts, batched+cached
    ruler.top_rules(theta, min_conf, optimal=True)  # the optimal rule set
    ruler.append(new_tx, classes=new_y)             # purge + hot-key prefetch

Every served rule is bit-exact against the host ``minority_report`` +
``optimal_rule_set`` oracle on the same history — asserted below over TWO
append rounds.  The store counts on ``--device`` (default: the card).

  PYTHONPATH=src python examples/torch/rule_server.py [rows] [append_rows] \
      [--device cuda|cpu]
"""
import argparse
import time

from repro_torch._device import resolve_device
from repro_torch.core import minority_report, optimal_rule_set
from repro_torch.data import bernoulli_db
from repro_torch.serve import CountServer, RuleServer

THETA, MIN_CONF = 0.02, 0.12


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

    tx, y = bernoulli_db(rows, 32, p_x=0.15, p_y=0.15, seed=3)
    ruler = RuleServer(CountServer(tx, classes=list(y), device=device),
                       prefetch_top=8)
    st = ruler.server.store
    print(f"resident {st.resident} DB: {st.n_rows} rows, {st.vocab.size} "
          f"items, version {st.version}")

    # ---- the full minority rule set, served from the store -----------------
    hist, ys = [list(t) for t in tx], list(y)
    t0 = time.time()
    rules = ruler.top_rules(THETA, MIN_CONF)
    opt = ruler.top_rules(THETA, MIN_CONF, optimal=True)
    print(f"top_rules(theta={THETA}, min_conf={MIN_CONF}): {len(rules)} "
          f"rules, {len(opt)} optimal ({time.time() - t0:.2f}s)")
    for r in opt[:3]:
        print(f"  {r}")
    res = minority_report(hist, ys, target_class=1, min_support=THETA,
                          min_confidence=MIN_CONF)
    assert rules == res.rules and opt == optimal_rule_set(res.rules)
    print(f"  == host minority_report/optimal_rule_set oracle "
          f"({len(res.rules)} rules)")

    # ---- hot rule queries hit the (antecedent, version, min_conf) cache ----
    hot = [r.antecedent for r in rules[:8]]
    ruler.rules_for(hot, min_conf=MIN_CONF)          # warm
    t0 = time.time()
    ruler.rules_for(hot, min_conf=MIN_CONF)          # pure cache hits
    print(f"hot repeat of {len(hot)} rule queries: "
          f"{1e6 * (time.time() - t0):.0f} us "
          f"(rule-cache hit rate {ruler.cache.hit_rate:.2f})")

    # ---- growth: two appends, rules re-verified at every version -----------
    for rnd in range(2):
        batch, yb = bernoulli_db(append_rows, 32, p_x=0.18, p_y=0.15,
                                 seed=10 + rnd)
        t0 = time.time()
        v = ruler.append(batch, classes=list(yb))    # purge + prefetch
        hist += [list(t) for t in batch]
        ys += list(yb)
        served = ruler.rules_for(hot, min_conf=MIN_CONF)
        res = minority_report(hist, ys, target_class=1, min_support=THETA,
                              min_confidence=MIN_CONF)
        assert ruler.top_rules(THETA, MIN_CONF) == res.rules
        assert ruler.top_rules(THETA, MIN_CONF, optimal=True) \
            == optimal_rule_set(res.rules)
        oracle = {r.antecedent: r for r in res.rules}
        assert all(rule == oracle.get(key)
                   for key, rule in zip(hot, served))
        print(f"append -> v{v} (+{len(batch)} rows, "
              f"{time.time() - t0:.2f}s): {len(res.rules)} rules, still == "
              f"host oracle; prefetched {ruler.n_prefetched_keys} hot keys "
              f"so far")
    s = ruler.stats()
    print(f"served {s['rule_queries']} rule queries; rule cache "
          f"{s['rule_cache']['hits']} hits / {s['rule_cache']['misses']} "
          f"misses; {s['prefetches']} prefetch rounds")


if __name__ == "__main__":
    main()
