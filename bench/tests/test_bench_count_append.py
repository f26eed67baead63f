"""The live-ingest cell ``sim-1m.count-append`` on the CPU at a tiny size:
``correct`` is true for the program and false for the control and for each
fault planted in the store or the server, a traced run reports the cell's
four new metrics, a server whose answers name no version gives no result,
and the versioned reference equals brute force."""
from __future__ import annotations

import json
import time

import numpy as np
import pytest

from bench import harness
from bench.generators.bernoulli_db import bernoulli_db
from bench.reference.table import item_matrix
from bench.reference.versioned import VersionedTable
from bench.tests.tiny import ROOT, TINY, edit_json, tiny_checkout

CELL = "sim-1m.count-append"
SEED = 2**31 + 29
NEW = {"append_ms.count", "delta_count_ms.count", "compact_s.count",
       "compactions.count"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_checkout(tmp_path_factory.mktemp("bench"))
    # the copy's cell at a CPU test's size.  Denser rows (p_x 0.3) let a
    # 20-row increment move most 2-itemsets' counts, so that an answer one
    # increment off shows.  The window opens with 900 delta rows, and the
    # store's floor of 1,024 rows starts a fold in its first second
    edit_json(root / "bench" / "configs" / "sim-1m-ingest.json",
              **TINY["configs/sim-1m.json"], p_x=0.3)
    edit_json(root / "bench" / "traffic" / "count-open-append.json",
              rate_per_s=60, check_requests=40, answer_wait_s=20,
              warmup_seconds=0.5, initial_delta_rows=400, append_rows=20)
    return root


def _run(root, seconds=1.5, trace=False, **kw):
    return harness.run_cell(root, CELL, SEED, seconds, trace, device="cpu",
                            check_chip=False, **kw)


def test_program_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"wrong_counts", "stale_answers",
                                  "missing_answers", "failed_appends"}
    assert out["failed"] == 0
    assert out["attempted"] == 90 + 75      # count requests and appends
    assert set(out["metrics"]) == {"count_p50_ms", "setup_s"}


def test_control_is_not_correct(root):
    out = _run(root, control=True)
    assert not out["correct"]
    assert out["checks"]["stale_answers"]["value"] > 0
    assert out["checks"]["wrong_counts"]["value"] > 0


def _drop_rows_appended_during_a_fold(monkeypatch):
    from repro_torch.serve import store

    real = store.VersionedDB._make_base

    def slow(self, *a, **k):          # appends land while the fold builds
        time.sleep(0.15)
        return real(self, *a, **k)

    monkeypatch.setattr(store.VersionedDB, "_make_base", slow)
    monkeypatch.setattr(store.DeltaSegment, "tail",
                        lambda self, start: store.DeltaSegment(
                            self.n_words, self.weights.shape[1], self.device))


def _version_one_ahead(monkeypatch):
    from repro_torch.serve.service import CountServer

    real = CountServer._resolve

    def ahead(self, keys):
        resolved, version = real(self, keys)
        return resolved, version + 1

    monkeypatch.setattr(CountServer, "_resolve", ahead)


def _delta_left_out(monkeypatch):
    from repro_torch.serve.store import VersionedDB

    monkeypatch.setattr(
        VersionedDB, "_count_delta",
        lambda self, masks, **kw: np.zeros((masks.shape[0], self.n_classes),
                                           np.int32))


@pytest.mark.parametrize("fault", [_drop_rows_appended_during_a_fold,
                                   _version_one_ahead, _delta_left_out])
def test_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(root)
    assert not out["correct"], out["checks"]


def test_a_traced_run_reports_the_new_metrics(root):
    out = _run(root, seconds=2.0, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert NEW <= set(got), NEW - set(got)
    assert got["compactions.count"]["value"] >= 1
    assert got["compact_s.count"]["value"] > 0
    assert got["append_ms.count"]["value"] > 0
    assert got["delta_count_ms.count"]["value"] > 0
    assert {"flush_ms.count", "queue_wait_ms.count"} <= set(got)


def test_answers_without_a_version_give_no_result(root, monkeypatch):
    """What the parent commit's server does: its futures carry no
    version."""
    from repro_torch.serve.async_loop import CountFuture

    real = CountFuture._set_result

    def unversioned(self, value, version):
        real(self, value, None)

    monkeypatch.setattr(CountFuture, "_set_result", unversioned)
    with pytest.raises(harness.HarnessError, match="no store version"):
        _run(root)


def _brute(rows, classes, itemset, n_classes=2):
    out = [0] * n_classes
    for t, c in zip(rows, classes):
        if set(itemset) <= set(t):
            out[int(c)] += 1
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_versioned_reference_equals_brute_force(seed):
    base, yb = bernoulli_db(150, 10, 0.3, 0.3, seed)
    more, ym = bernoulli_db(90, 10, 0.3, 0.3, seed + 10)
    rows_at = {0: 150, 1: 180, 2: 210, 5: 240}
    history = base + more
    classes = np.concatenate([yb, ym])
    mat, items = item_matrix(history)
    ref = VersionedTable(mat, classes, 2, items, rows_at)
    rng = np.random.default_rng(seed)
    sets = [tuple(rng.choice(10, size=int(rng.integers(1, 4)),
                             replace=False).tolist()) for _ in range(30)]
    sets += [(), (99,)]
    for v, n in rows_at.items():
        want = [_brute(history[:n], classes[:n], s) for s in sets]
        np.testing.assert_array_equal(ref.counts_at(v, sets), want)
    with pytest.raises(KeyError):
        ref.counts_at(3, sets)


def test_ingest_configuration_keeps_the_sim_1m_table():
    """The live-ingest deployment serves section 4.3's table as ``sim-1m``
    has it, nothing cut, and builds its server the way it states."""
    configs = ROOT / "bench" / "configs"
    ingest = json.loads((configs / "sim-1m-ingest.json").read_text())
    table = json.loads((configs / "sim-1m.json").read_text())
    for key, value in table.items():
        if isinstance(value, (int, float)):
            assert ingest[key] == value, key
    assert ingest["generator"] == table["generator"]
    assert ingest["reduced"] == []
    assert ingest["server"]["background_compaction"] is True
    assert ingest["server"]["async_flush"] is True
