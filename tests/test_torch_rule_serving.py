"""The port's minority-rule serving (``repro_torch.serve.rules``) against the
JAX package's (``repro.serve.rules``), on the same numpy-seeded inputs, with
exact equality.

Two parts:

  * the JAX package's own rule-serving battery (``tests/test_rule_serving.py``
    but its launcher test, which ``tests/test_torch_serve_counts.py`` runs
    against the port's launcher) re-run against the port, with every
    oracle computed by the JAX package's host ``minority_report`` /
    ``optimal_rule_set``: a served rule equals the oracle's field for field
    (``dataclasses.astuple``, floats compared exactly);
  * side-by-side runs: the same server, rule traffic, appends and
    ``top_rules`` calls in both packages, every ``Rule`` and every
    ``stats()`` field equal where the fields mean the same.

On the CPU every count runs the plain PyTorch version.  The reference's
slow mesh case runs on gloo meshes in ``tests/test_torch_serving_mesh.py``.
"""
import functools
from dataclasses import astuple

import numpy as np
import pytest

import repro.core as jcore
import repro.serve as js
from repro_torch.core import is_optimal_set, optimal_rule_set
from repro_torch.core.incremental import ceil_count
from repro_torch.core.mra import Rule
from repro_torch.mining import MiningCheckpoint
from repro_torch.roofline import autotune as at
from repro_torch.serve import (CountServer, MiningRefreshError, RuleCache,
                               RuleServer)
from repro_torch.serve.cache import check_cache_ledger

from _pbt import given, settings, strategies as st  # hypothesis or offline shim

THETA, MIN_CONF = 0.04, 0.36

# the port's entry points default to the card; these tests ask for the host
_server = functools.partial(CountServer, device="cpu")


@pytest.fixture(autouse=True)
def _untuned():
    """Pin the port's autotuner to the compiled-in defaults (``conftest.py``
    pins the JAX package's)."""
    at.set_active_table(None)
    yield
    at.set_active_table(None)


def _db(rng, rows, items, p=0.3):
    return [[int(a) for a in range(items) if rng.random() < p]
            for _ in range(rows)]


def _labels(rng, tx, p=0.35):
    return [int(rng.random() < p) for _ in tx]


def _t(rules):
    """Rules (or None verdicts) of either package as comparable tuples."""
    return [None if r is None else astuple(r) for r in rules]


def _oracle(hist, ys, theta=THETA, min_conf=MIN_CONF, target_class=1):
    return jcore.minority_report(hist, ys, target_class=target_class,
                                 min_support=theta,
                                 min_confidence=min_conf).rules


# =================================================== the reference's battery
def _battery(make_server, rounds=2, seed=7):
    """Serve rules over ``rounds`` append rounds; every round must match the
    host oracle exactly (complete rule list, optimal set, per-antecedent
    verdicts)."""
    rng = np.random.default_rng(seed)
    tx = _db(rng, 300, 24)
    y = _labels(rng, tx)
    ruler = RuleServer(make_server(tx, y))
    hist, ys = [list(t) for t in tx], list(y)
    for rnd in range(rounds + 1):
        want = _oracle(hist, ys)
        assert want, f"round {rnd}: oracle mined no rules (bad params)"
        got = ruler.top_rules(THETA, MIN_CONF)
        assert _t(got) == _t(want), f"round {rnd}: complete rule set diverged"
        assert _t(ruler.top_rules(THETA, MIN_CONF, optimal=True)) \
            == _t(jcore.optimal_rule_set(want)), f"round {rnd}: optimal set"
        # per-antecedent verdicts through the cache/batch path: Rule equality
        # covers count, g_count, support AND confidence bit-exactly
        antes = [r.antecedent for r in want]
        assert _t(ruler.rules_for(antes, min_conf=MIN_CONF)) == _t(want)
        if rnd < rounds:
            batch = _db(rng, 120, 24 + 4 * rnd)   # widens the vocab too
            yb = _labels(rng, batch)
            ruler.append(batch, classes=yb)
            hist += [list(t) for t in batch]
            ys += yb


def test_top_rules_oracle_parity_dense_over_appends():
    _battery(lambda tx, y: _server(tx, classes=y))


def test_top_rules_oracle_parity_streaming_store():
    _battery(lambda tx, y: _server(tx, classes=y, streaming=True,
                                   chunk_rows=64))


def test_top_rules_oracle_parity_sharded_host_loop():
    _battery(lambda tx, y: _server(tx, classes=y, shards=4))


def test_top_rules_oracle_parity_spilled_store(tmp_path):
    _battery(lambda tx, y: _server(tx, classes=y, chunk_rows=64,
                                   spill_dir=str(tmp_path),
                                   spill_threshold_bytes=0))


def test_rules_for_verdicts_unknown_empty_and_target_override():
    rng = np.random.default_rng(11)
    tx = _db(rng, 200, 12)
    y = [i % 3 for i in range(len(tx))]          # 3 classes
    ruler = RuleServer(_server(tx, classes=y, n_classes=3),
                       target_class=2)
    # empty antecedent = the class prior
    (prior,) = ruler.rules_for([()])
    n2 = sum(1 for c in y if c == 2)
    assert prior == Rule((), 2, n2 / len(tx), n2 / len(tx),
                         n2, len(tx) - n2)
    # unknown item: exact count 0 on both sides -> confidence 0
    (unk,) = ruler.rules_for([(999,)])
    assert unk == Rule((999,), 2, 0.0, 0.0, 0, 0)
    assert ruler.rules_for([(999,)], min_conf=0.1) == [None]
    # per-call target override beats the constructor default
    (r0,) = ruler.rules_for([(0,)], target_class=0)
    (r2,) = ruler.rules_for([(0,)])
    assert r0.consequent == 0 and r2.consequent == 2
    assert r0.count + r0.g_count == r2.count + r2.g_count
    # canonicalization: permuted/duplicated antecedents are one verdict
    a, b = ruler.rules_for([(3, 1, 1), (1, 3)])
    assert a == b and a.antecedent == (1, 3)
    # and every verdict equals the JAX package's
    jruler = js.RuleServer(js.CountServer(tx, classes=y, n_classes=3),
                           target_class=2)
    probe = [(), (999,), (0,), (3, 1, 1), (1, 3), (2, 5)]
    for tc in (None, 0, 1):
        assert _t(ruler.rules_for(probe, target_class=tc)) \
            == _t(jruler.rules_for(probe, target_class=tc))


def test_rule_server_validation():
    srv = _server([[1, 2], [2]], classes=[0, 1])
    with pytest.raises(ValueError, match="target_class"):
        RuleServer(srv, target_class=2)
    with pytest.raises(ValueError, match="prefetch_top"):
        RuleServer(srv, prefetch_top=-1)
    with pytest.raises(ValueError, match="heat_capacity"):
        RuleServer(srv, heat_capacity=0)
    ruler = RuleServer(srv)
    with pytest.raises(ValueError, match="target_class"):
        ruler.rules_for([(1,)], target_class=5)
    with pytest.raises(ValueError, match="min_conf"):
        ruler.rules_for([(1,)], min_conf=1.5)
    with pytest.raises(ValueError, match="class_column"):
        srv.mine(0.5, class_column=3)


def test_class_guided_mine_matches_oracle_and_does_not_arm():
    rng = np.random.default_rng(23)
    tx = _db(rng, 250, 16)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    got = srv.mine(0.05, class_column=1)
    # guided mine == host FP-growth over the target-class rows only
    want = jcore.mine_frequent([t for t, c in zip(tx, y) if c == 1],
                               ceil_count(0.05 * len(tx)))
    assert got == want
    with pytest.raises(RuntimeError, match="mine"):
        srv.frequent        # the class-guided query must NOT arm maintenance


def test_class_guided_mine_discards_total_count_checkpoint(tmp_path):
    """A checkpoint saved by a total-count mine must NOT answer a
    class-guided resume at the same version (or vice versa): the mining
    parameters are part of the checkpoint identity."""
    rng = np.random.default_rng(47)
    tx = _db(rng, 200, 16)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    ruler = RuleServer(srv)
    cp = MiningCheckpoint(str(tmp_path / "mine.json"))
    srv.mine(0.1, checkpoint=cp)                     # total-count state saved
    got = ruler.top_rules(0.1, 0.0, checkpoint=cp)   # must not resume from it
    assert _t(got) == _t(_oracle(tx, y, 0.1, 0.0))
    # reverse direction: the class-guided state must not answer a total mine
    assert srv.mine(0.1, checkpoint=cp) \
        == jcore.mine_frequent(tx, ceil_count(0.1 * len(tx)))


def test_threshold_boundary_fp_noise_parity():
    """0.07 * 100 == 7.000000000000001: the epsilon-guarded ceil keeps an
    exactly-at-threshold antecedent on BOTH the host and serving sides."""
    tx = [[0] if i < 7 else [1] for i in range(100)]
    y = [1] * 7 + [0] * 93
    want = _oracle(tx, y, 0.07, 0.0)
    assert any(r.antecedent == (0,) and r.count == 7 for r in want)
    ruler = RuleServer(_server(tx, classes=y))
    assert _t(ruler.top_rules(0.07, 0.0)) == _t(want)


# ------------------------------------------------------------ rule cache
def test_rule_cache_stale_version_never_served_after_append():
    rng = np.random.default_rng(31)
    tx = _db(rng, 150, 10)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    ruler = RuleServer(srv)
    (before,) = ruler.rules_for([(0,)])
    # append BEHIND the rule server (no purge, no prefetch): the v0 entry is
    # still resident, yet the version key makes it unservable
    batch = [[0, 1]] * 40
    srv.append(batch, classes=[1] * 40)
    assert len(ruler.cache) == 1
    (after,) = ruler.rules_for([(0,)])
    assert after != before
    n = len(tx) + 40
    cnt = sum(1 for t, c in zip(tx, y) if 0 in t and c == 1) + 40
    gcnt = sum(1 for t, c in zip(tx, y) if 0 in t and c == 0)
    assert after == Rule((0,), 1, cnt / n, cnt / (cnt + gcnt), cnt, gcnt)
    # the stale v0 verdict is purgeable and the ledger follows it out
    assert ruler.cache.purge_stale(srv.store.version) == 1
    assert ruler.cache.nbytes == RuleCache.entry_nbytes(after)


def test_rule_cache_prefetch_warms_only_current_version_keys():
    rng = np.random.default_rng(37)
    tx = _db(rng, 200, 12)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    ruler = RuleServer(srv, prefetch_top=4)
    hot = [(0,), (1,), (0, 1), (2,)]
    for _ in range(3):                           # build heat on 4 keys
        ruler.rules_for(hot, min_conf=0.1)
    ruler.rules_for([(5,), (6,)], min_conf=0.1)  # colder keys
    batch = _db(rng, 60, 12)
    v = ruler.append(batch, classes=_labels(rng, batch))
    assert ruler.n_prefetches == 1
    # ONLY current-version entries are resident (stale purged, warm rewarmed)
    assert len(ruler.cache) == 4
    assert all(k[1] == v for k in ruler.cache._d)
    # hot keys are answered without any device work
    launches = srv.store.kernel_launches
    hits0 = ruler.cache.hits
    got = ruler.rules_for(hot, min_conf=0.1)
    assert srv.store.kernel_launches == launches
    assert ruler.cache.hits == hits0 + 4
    # and the prefetched verdicts are the CURRENT counts (full history)
    hist = [list(t) for t in tx] + [list(t) for t in batch]
    assert got[0] is not None
    assert got[0].count + got[0].g_count == sum(1 for t in hist if 0 in t)


def test_rule_cache_ledgers_exact_under_mixed_rule_count_traffic():
    rng = np.random.default_rng(41)
    tx = _db(rng, 180, 14)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    ruler = RuleServer(srv, cache_size=6, cache_bytes=260, prefetch_top=0)
    pool = [(a,) for a in range(10)] + [(0, 1), (2, 3), (4, 5, 6)]
    purged = 0
    for rnd in range(3):
        ruler.rules_for(pool[rnd:rnd + 8], min_conf=0.2)
        srv.query(pool[rnd:rnd + 4])             # count traffic interleaves
        if rnd == 1:
            # a 12-item antecedent prices at 96+16*12=288 > max_bytes: the
            # oversized-reject path under live traffic
            ruler.rules_for([tuple(range(12))], min_conf=0.0)
            batch = _db(rng, 40, 14)
            srv.append(batch, classes=_labels(rng, batch))
            purged += ruler.cache.purge_stale(srv.store.version)
    cache = ruler.cache
    st_ = check_cache_ledger(cache, miss_driven=True)
    assert st_["oversized_rejects"] == 1
    assert st_["purged"] == purged
    assert st_["evictions"] > 0                  # budget actually exercised
    # count-cache ledger untouched by rule traffic beyond its own entries
    check_cache_ledger(srv.cache, miss_driven=True)


def test_rule_cache_lru_eviction_oversized_reject_and_none_verdicts():
    cache = RuleCache(capacity=2, max_bytes=300)
    r1 = Rule((1,), 1, 0.1, 0.5, 5, 5)
    r12 = Rule((1, 2), 1, 0.1, 0.5, 5, 5)
    cache.put(((1,), 1, 0.3), 0, r1)
    cache.put(((1, 2), 1, 0.3), 0, None)         # None verdict is cached
    hit, rule = cache.get(((1, 2), 1, 0.3), 0)
    assert hit and rule is None
    assert cache.nbytes == RuleCache.entry_nbytes(r1) + 16
    cache.put(((3,), 1, 0.3), 0, r12)            # capacity 2: LRU evicts
    assert len(cache) == 2 and cache.evictions == 1
    hit, _ = cache.get(((1,), 1, 0.3), 0)        # (1,) was LRU -> gone
    assert not hit
    big = RuleCache(capacity=8, max_bytes=120)
    big.put(((1,), 1, 0.0), 0, r1)               # 112 bytes: fits
    big.put(((1, 2), 1, 0.0), 0, r12)            # 128 bytes: NEVER fits
    assert big.oversized_rejects == 1 and len(big) == 1
    assert big.nbytes == RuleCache.entry_nbytes(r1)
    with pytest.raises(ValueError):
        RuleCache(capacity=0)
    with pytest.raises(ValueError):
        RuleCache(max_bytes=0)
    # the same pricing as the JAX package's rule cache
    for r in (None, r1, r12, Rule(tuple(range(12)), 1, 0.0, 0.0, 0, 0)):
        jr = None if r is None else jcore.Rule(*astuple(r))
        assert RuleCache.entry_nbytes(r) == js.RuleCache.entry_nbytes(jr)


def test_rule_server_append_prefetches_even_on_mining_refresh_error(
        monkeypatch):
    rng = np.random.default_rng(43)
    tx = _db(rng, 150, 10)
    y = _labels(rng, tx)
    srv = _server(tx, classes=y)
    ruler = RuleServer(srv, prefetch_top=2)
    srv.mine(0.1)
    ruler.rules_for([(0,), (1,)], min_conf=0.1)
    monkeypatch.setattr(srv, "_refresh_frequent",
                        lambda inc: (_ for _ in ()).throw(RuntimeError("x")))
    batch = _db(rng, 30, 10)
    with pytest.raises(MiningRefreshError):
        ruler.append(batch, classes=_labels(rng, batch))
    # the batch IS committed: the rule path purged + re-warmed at the new
    # version anyway — no stale verdict can survive the failed refresh
    v = srv.store.version
    assert v == 1 and ruler.n_prefetches == 1
    assert ruler.cache._d and all(k[1] == v for k in ruler.cache._d)


# ------------------------------------------- optimal_rule_set property test
_EPS = 1e-12
_CONFS = [0.2, 0.5 - 5e-13, 0.5, 0.5 + 5e-13, 0.5 + 4e-12, 0.8, 1.0]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 15 * len(_CONFS) - 1),
                min_size=0, max_size=24))
def test_optimal_rule_set_matches_bruteforce_domination(codes):
    """Subset-enumeration filter == brute-force pairwise domination oracle
    == the JAX package's filter, with confidence ties exercised
    within/just-outside the eps band."""
    rules, seen = [], set()
    for code in codes:
        mask = code % 15 + 1                      # non-empty subset of 4 items
        conf = _CONFS[code // 15]
        ante = tuple(a for a in range(4) if (mask >> a) & 1)
        if ante in seen:                          # one confidence per ante,
            continue                              # like a real mined rule set
        seen.add(ante)
        rules.append(Rule(ante, 1, 0.1, conf, 10, 5))
    got = optimal_rule_set(rules)
    brute = [r for r in rules
             if not any(set(s.antecedent) < set(r.antecedent)
                        and s.confidence >= r.confidence - _EPS
                        for s in rules)]
    assert got == brute
    assert is_optimal_set(got, rules)
    jrules = [jcore.Rule(*astuple(r)) for r in rules]
    assert _t(got) == _t(jcore.optimal_rule_set(jrules))


# =================================================== side by side with JAX
def _twins(make_kw, seed, rows=260, items=18, **rule_kw):
    rng = np.random.default_rng(seed)
    tx = _db(rng, rows, items)
    y = _labels(rng, tx)
    ruler = RuleServer(_server(tx, classes=y, **make_kw()), **rule_kw)
    jruler = js.RuleServer(js.CountServer(tx, classes=y, **make_kw()),
                           **rule_kw)
    return rng, tx, y, ruler, jruler


def _same_rule_stats(a: dict, b: dict):
    """``RuleServer.stats()`` of the two packages: every field equal."""
    assert a.keys() == b.keys()
    assert a == b


@pytest.mark.parametrize("kind", ["dense", "streaming", "sharded"])
def test_rule_server_matches_jax_over_appends(kind):
    """The same rule traffic, appends and top_rules calls in both packages:
    every served Rule equal field for field, the same prefetches, the same
    rule-cache ledger and the same ``stats()``."""
    make_kw = {"dense": dict, "streaming": lambda: dict(streaming=True,
                                                         chunk_rows=48),
               "sharded": lambda: dict(shards=3)}[kind]
    rng, tx, y, ruler, jruler = _twins(make_kw, seed=61, prefetch_top=5,
                                       cache_size=64)
    pool = [tuple(sorted(rng.choice(20, size=int(rng.integers(0, 4)),
                                    replace=False).tolist()))
            for _ in range(40)]
    for rnd in range(4):
        for tc, mc in ((None, 0.3), (0, 0.5), (1, 0.0)):
            picks = [pool[int(i)] for i in rng.integers(0, len(pool), 12)]
            got = ruler.rules_for(picks, target_class=tc, min_conf=mc)
            want = jruler.rules_for(picks, target_class=tc, min_conf=mc)
            assert _t(got) == _t(want), (rnd, tc, mc)
        for optimal in (False, True):
            got = ruler.top_rules(0.03, 0.3, optimal=optimal)
            want = jruler.top_rules(0.03, 0.3, optimal=optimal)
            assert got and _t(got) == _t(want), (rnd, optimal)
        assert _t(ruler.top_rules(0.05, 0.0, target_class=0)) \
            == _t(jruler.top_rules(0.05, 0.0, target_class=0))
        _same_rule_stats(ruler.stats(), jruler.stats())
        batch = _db(rng, 50, 18 + 2 * rnd)       # new items widen the vocab
        yb = _labels(rng, batch)
        assert ruler.append(batch, classes=yb) \
            == jruler.append(batch, classes=yb) == rnd + 1
        assert sorted(ruler.cache._d, key=repr) \
            == sorted(jruler.cache._d, key=repr)
    _same_rule_stats(ruler.stats(), jruler.stats())
    assert ruler.stats()["prefetches"] == 4


def test_rule_server_matches_jax_without_cache_and_tiny_heat():
    rng, tx, y, ruler, jruler = _twins(dict, seed=67, cache=False,
                                       heat_capacity=6, prefetch_top=2)
    keys = [(a,) for a in range(12)] + [(0, 1), (2, 3)]
    for _ in range(3):
        picks = [keys[int(i)] for i in rng.integers(0, len(keys), 9)]
        assert _t(ruler.rules_for(picks, min_conf=0.2)) \
            == _t(jruler.rules_for(picks, min_conf=0.2))
        assert ruler._heat == jruler._heat       # the same trims
    batch = _db(rng, 30, 18)
    yb = _labels(rng, batch)
    assert ruler.append(batch, classes=yb) \
        == jruler.append(batch, classes=yb) == 1
    assert _t(ruler.rules_for(keys, min_conf=0.0)) \
        == _t(jruler.rules_for(keys, min_conf=0.0))
    _same_rule_stats(ruler.stats(), jruler.stats())
    assert ruler.stats()["rule_cache"] is None
