"""The readers of the program's layer spans: each on a hand-built record,
none where the program records no such span, and every one of them in a
tiny traced run of a mine cell and of a count cell on the CPU."""
from __future__ import annotations

import gc
import json

import pytest

from bench import harness
from bench.tests.tiny import ROOT, tiny_checkout

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

MINE = {"scan_s.mine": "mra.scan", "bitmap_s.mine": "encode.bitmap",
        "dedup_s.mine": "encode.dedup", "candidates_s.mine": "mine.candidates",
        "absorb_s.mine": "mine.absorb", "gc_s.mine": "py.gc",
        "singles_s.mine": "mine.singles"}
COUNT = {"queue_wait_ms.count": "serve.queued",
         "lock_wait_ms.count": "serve.lock_wait",
         "cache_lookup_ms.count": "serve.cache_lookup",
         "masks_ms.count": "serve.masks",
         "dispatch_ms.count": "serve.dispatch"}


def _read(name: str, rec) -> float:
    reader = harness.load_file(ROOT / "bench" / "metrics" / f"{name}.py",
                               "bench_metric_" + name.replace(".", "_"))
    return reader.read(rec)


def _mine_record(span: str) -> harness.Record:
    # two jobs; a span before the first job is not counted
    return harness.Record(
        trace=True, jobs=[{"t0": 10.0, "t1": 20.0}, {"t0": 20.0, "t1": 30.0}],
        spans=[(span, 11.0, 12.5), (span, 13.0, 13.5), (span, 21.0, 23.0),
               (span, 5.0, 9.0), ("other", 11.0, 19.0)])


def _count_record(span: str) -> harness.Record:
    # the window is [100, 110]; a span starting outside it is not counted
    return harness.Record(
        trace=True, window_t0=100.0, window_t1=110.0,
        spans=[(span, 100.5, 100.502), (span, 104.0, 104.006),
               (span, 99.0, 99.5), ("other", 100.0, 101.0)])


@pytest.mark.parametrize("name", sorted(MINE))
def test_a_mine_reader_gives_seconds_per_job(name):
    assert _read(name, _mine_record(MINE[name])) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(COUNT))
def test_a_count_reader_gives_the_mean_span(name):
    assert _read(name, _count_record(COUNT[name])) == pytest.approx(4.0)


def test_gc_share_of_the_window():
    rec = _count_record("py.gc")
    assert _read("gc_pct.count", rec) == pytest.approx(100 * 0.008 / 10)


@pytest.mark.parametrize("name", sorted(MINE) + sorted(COUNT)
                         + ["gc_pct.count"])
def test_no_number_without_the_span_or_the_trace(name):
    rec = (_mine_record("other") if name in MINE
           else _count_record("other"))
    assert _read(name, rec) is None
    span = MINE.get(name) or COUNT.get(name) or "py.gc"
    rec = _mine_record(span) if name in MINE else _count_record(span)
    rec.trace = False
    assert _read(name, rec) is None


def _new_metrics(cell: str) -> set:
    return {m["name"] for m in SPEC["per_layer"]
            if m["name"] in set(MINE) | set(COUNT) | {"gc_pct.count"}
            and cell in m["workloads"]}


@pytest.mark.parametrize("cell", ["census-adult.mine", "sim-1m.count-cold"])
def test_a_tiny_traced_run_reports_every_new_metric(tmp_path, monkeypatch,
                                                    cell):
    want = _new_metrics(cell)
    assert len(want) == (7 if cell.endswith(".mine") else 6)
    root = tiny_checkout(tmp_path)
    opens = harness.RunContext.window_opens

    def opens_with_a_collection(ctx):
        # a tiny window may see no collection of its own; the 51 s windows
        # on the card see hundreds
        t0 = opens(ctx)
        gc.collect(0)
        return t0

    monkeypatch.setattr(harness.RunContext, "window_opens",
                        opens_with_a_collection)
    out = harness.run_cell(root, cell, 2**31 + 11, 1.0, True, device="cpu",
                           check_chip=False)
    assert out["correct"]
    got = out["metrics"]
    assert want <= set(got), want - set(got)
    for name in want:
        assert got[name]["value"] >= 0, name
