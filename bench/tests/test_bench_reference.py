"""The benchmark's plain reference, its frozen generators and its frozen
roofline count, held against brute force at tiny sizes (CPU)."""
from __future__ import annotations

import itertools
import math

import numpy as np
import pytest

from bench.generators.bernoulli_db import bernoulli_db
from bench.generators.census_like_db import CENSUS_COLUMNS, census_like_db
from bench.metrics import _roofline
from bench.reference.mra import Pass, minority_report
from bench.reference.table import (PackedTable, distinct_rows, item_matrix,
                                   popcount_rows)


def brute_counts(tx, y, itemset, n_classes=2):
    s = set(itemset)
    out = [0] * n_classes
    for t, c in zip(tx, y):
        if s <= set(t):
            out[int(c)] += 1
    return out


def brute_rules(tx, y, min_support, min_confidence):
    """The Minority-Report rule list by enumerating every itemset."""
    n = len(tx)
    rare = [set(t) for t, c in zip(tx, y) if c == 1]
    items = sorted({a for t in tx for a in t}, key=repr)
    kept = [a for a in items
            if sum(a in t for t in rare) >= min_support * n]
    min_count = max(1, math.ceil(min_support * n - 1e-9))
    rules = {}
    for k in range(1, len(kept) + 1):
        any_frequent = False
        for s in itertools.combinations(kept, k):
            c1 = sum(set(s) <= t for t in rare)
            if c1 < min_count:
                continue
            any_frequent = True
            c0 = brute_counts(tx, y, s)[0]
            conf = c1 / (c1 + c0)
            if conf >= min_confidence:
                rules[frozenset(s)] = (c1, c0, c1 / n, conf)
        if not any_frequent:
            break
    return rules


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_counts_equal_brute_force(seed):
    tx, y = bernoulli_db(300, 12, 0.3, 0.3, seed)
    table = PackedTable.from_transactions(tx, y)
    rng = np.random.default_rng(seed)
    sets = [tuple(rng.choice(12, size=int(rng.integers(1, 5)),
                             replace=False).tolist()) for _ in range(60)]
    sets += [(), (99,), (0, 99)]
    got = table.counts(sets)
    want = [brute_counts(tx, y, s) for s in sets[:-2]] + [[0, 0], [0, 0]]
    assert got.tolist() == want


def test_popcount_without_bitwise_count_agrees(monkeypatch):
    words = np.random.default_rng(3).integers(0, 2**63, size=(7, 5),
                                              dtype=np.int64).view(np.uint64)
    want = [sum(bin(int(w)).count("1") for w in row) for row in words]
    assert popcount_rows(words).tolist() == want
    monkeypatch.delattr(np, "bitwise_count", raising=False)
    assert popcount_rows(words).tolist() == want


@pytest.mark.parametrize("seed,min_support,min_conf", [
    (0, 0.02, 0.0), (1, 0.03, 0.2), (2, 0.05, 0.1)])
def test_rule_list_equals_brute_force(seed, min_support, min_conf):
    tx, y = bernoulli_db(400, 10, 0.35, 0.25, seed)
    ref = minority_report(tx, y, min_support=min_support,
                          min_confidence=min_conf)
    assert ref.rules == brute_rules(tx, y, min_support, min_conf)
    assert ref.rules


def test_rule_list_on_strings_equals_brute_force():
    tx, y = census_like_db(300, 0.2, 5)
    tx = [t[:5] for t in tx]          # five columns keep brute force small
    ref = minority_report(tx, y, min_support=0.02, min_confidence=0.05)
    assert ref.rules == brute_rules(tx, y, 0.02, 0.05)


def test_control_drops_multiplicity_and_differs():
    tx, y = bernoulli_db(400, 6, 0.3, 0.3, 4)    # 6 items: many duplicates
    ref = minority_report(tx, y, min_support=0.02, min_confidence=0.0)
    ctl = minority_report(tx, y, min_support=0.02, min_confidence=0.0,
                          multiplicity=False)
    assert ref.rules != ctl.rules
    assert all(c[0] <= r[0] for k, c in ctl.rules.items()
               for r in [ref.rules.get(k, c)])


def test_generators_first_rows_are_frozen():
    tx, y = bernoulli_db(50, 20, 0.3, 0.2, 12345)
    assert tx[:2] == [[0, 7, 10, 13, 19], [0, 1, 4, 6, 7, 8, 19]]
    assert y[:12].tolist() == [1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0]
    tx, y = bernoulli_db(50, 60, 0.125, 0.01, [7, 0])
    assert tx[:3] == [[6, 23, 24, 32, 37, 46, 52], [7, 30, 36, 38, 39, 54],
                      [0, 26, 39, 43, 54, 59]]
    tx, y = census_like_db(100, 0.05, [7, 0], 0.35)
    assert tx[1] == ["age=1", "workclass=1", "fnlwgt=0", "education=6",
                     "marital.status=3", "occupation=4", "relationship=3",
                     "race=2", "sex=1", "hours.per.week=1",
                     "native.country=3", "salary_proxy_bin=1"]
    assert y.nonzero()[0].tolist() == [57, 60, 67, 88, 90]


def test_census_shape():
    tx, y = census_like_db(2000, 0.01, 3)
    assert int(y.sum()) == 20
    assert all(len(t) == len(CENSUS_COLUMNS) for t in tx)
    assert len({a for t in tx for a in t}) <= 115
    assert sum(k for _, k in CENSUS_COLUMNS) == 115


def test_distinct_rows_counts_each_row_once():
    mat, _ = item_matrix([[1, 2], [2, 1], [3], [], [], [1, 2, 3]])
    assert distinct_rows(mat) == 4
    assert distinct_rows(mat[:0]) == 0


def test_roofline_counts_distinct_rows_once_and_ignores_routes():
    tx, y = bernoulli_db(600, 8, 0.3, 0.3, 9)
    once = minority_report(tx, y, min_support=0.05, min_confidence=0.0)
    twice = minority_report(tx + tx, np.concatenate([y, y]),
                            min_support=0.05, min_confidence=0.0)
    # the same distinct rows and antecedents: the same work, though every
    # row now appears twice
    assert [(p.rows, p.k, p.target_sizes) for p in once.passes] == \
        [(p.rows, p.k, p.target_sizes) for p in twice.passes]
    assert _roofline.least_seconds(once.passes) == \
        _roofline.least_seconds(twice.passes)


def test_roofline_arithmetic():
    p = Pass(rows=64, k=3, w=2, c=2, target_sizes=(1, 2, 5))
    assert _roofline.kernel_bytes(64, 3, 2, 2) == 4 * (128 + 128 + 6 + 6)
    assert _roofline.and_ops(64, (1, 2, 5)) == 2 * (0 + 1 + 2)
    assert _roofline.least_seconds([p]) == max(
        4 * 268 / 3.35e12, 6 / (132 * 64 * 1.98e9))
