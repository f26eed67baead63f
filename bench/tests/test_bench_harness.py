"""The benchmark's own rules, on the CPU: names and units, which cells
report what, a new cell made of new files alone, and no JAX anywhere."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
import sys
from collections import deque
from pathlib import Path

import pytest

from bench import devtrace, harness
from bench.tests.tiny import ROOT, tiny_checkout

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_spec_keys_and_names():
    assert set(SPEC) == TOP_KEYS
    names = [m["name"] for m in _metrics()]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in _metrics()}) == len(_metrics())
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = harness.resolve(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        assert w["chips"] in (1, 4)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", []):
            target = e2e[m["moves"]]
            assert cell in target.get("workloads", [cell]), (m["name"], cell)


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "bench" / "generators"
                / f"{cfg['generator']}.py").is_file()
        assert c["file"].startswith("bench/")
    for w in SPEC["workloads"]:
        mix = json.loads((ROOT / "bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "bench" / "drivers" / f"{mix['kind']}.py").is_file()
    for m in _metrics():
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    assert SPEC["command"][1:] == ["bench/run.py"]
    assert SPEC["paths"] == ["bench"]


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path):
    root = tiny_checkout(tmp_path)
    before = _digests(root)
    bench = root / "bench"
    (bench / "configs" / "sim-small.json").write_text(json.dumps(dict(
        json.loads((bench / "configs" / "sim-1m.json").read_text()),
        name="sim-small", n_transactions=2000, n_items=16)))
    (bench / "traffic" / "count-open-warm.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "count-open-hot.json").read_text()),
        catalogue=50, zipf_s=2.0)))
    (bench / "metrics" / "answered.count.py").write_text(
        "def read(rec):\n    return float(rec.attempted - rec.failed)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sim-small", "source": "x",
                            "file": "bench/configs/sim-small.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "sim-small.warm", "config": "sim-small",
                              "traffic": "count-open-warm", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("count_p95_ms", "cache_hit_pct.count",
                         "queries_per_flush.count", "flush_ms.count"):
            m["workloads"].append("sim-small.warm")
    spec["per_layer"].append({"name": "answered.count", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "count server",
                              "moves": "count_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell(root, "sim-small.warm", 5, 1.0, False,
                           device="cpu", check_chip=False)
    assert out["correct"] and set(out["metrics"]) == {"count_p95_ms",
                                                      "setup_s"}
    out = harness.run_cell(root, "sim-small.warm", 6, 1.0, True,
                           device="cpu", check_chip=False)
    assert out["correct"]
    assert out["metrics"]["answered.count"]["value"] == out["attempted"]
    assert out["metrics"]["cache_hit_pct.count"]["value"] > 50
    assert out["metrics"]["queries_per_flush.count"]["value"] > 0
    assert out["metrics"]["flush_ms.count"]["value"] > 0
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_reference_imports_nothing_of_the_program():
    for path in [*(ROOT / "bench" / "reference").glob("*.py"),
                 *(ROOT / "bench" / "generators").glob("*.py"),
                 ROOT / "bench" / "metrics" / "_roofline.py",
                 ROOT / "bench" / "workload.py"]:
        for name in _imports(path):
            assert name.partition(".")[0] not in {"repro_torch", "repro",
                                                  "jax", "jaxlib", "flax"}, \
                (path, name)


_PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from bench import harness
{body}
print(sorted({{m.partition('.')[0] for m in sys.modules}}))
"""


def _loaded(body: str) -> set:
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_a_whole_run(tmp_path):
    root = tiny_checkout(tmp_path)
    loaded = _loaded(
        f"for cell in ('sim-1m.mine', 'sim-1m.count-hot'):\n"
        f"    harness.run_cell(Path({str(root)!r}), cell, 3, 0.5, True,"
        f" device='cpu', check_chip=False)")
    assert "repro_torch" in loaded
    assert not loaded & harness.FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import bench.reference.mra, bench.reference.table, "
                     "bench.workload, bench.metrics._roofline")
    assert not loaded & (harness.FORBIDDEN | {"repro_torch"})


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro_torchlike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


@pytest.mark.parametrize("layout", ["checkout", "bench-only"])
def test_no_result_without_a_chip_or_the_program(tmp_path, layout):
    root = ROOT
    if layout == "bench-only":
        root = tiny_checkout(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "sim-1m.mine",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_span_drain_empties_the_ring():
    class Span:
        def __init__(self, i):
            self.name, self.t0, self.t1 = f"s{i}", float(i), i + 0.5

    class Tracer:
        _ring = deque(maxlen=4)

    with harness.SpanDrain(Tracer, period_s=0.001) as drain:
        for i in range(50):
            Tracer._ring.append(Span(i))
            if i % 3 == 0:
                drain._take()
    assert [s[0] for s in drain.spans][-1] == "s49"
    assert not Tracer._ring


def test_device_timeline_arithmetic():
    ops = [("k", 1.0, 0.5), ("Memcpy HtoD", 1.25, 0.5), ("k", 3.0, 1.0)]
    assert devtrace.union_seconds(ops, 0.0, 5.0) == pytest.approx(1.75)
    assert devtrace.union_seconds(ops, 1.5, 3.5) == pytest.approx(0.75)
    assert devtrace.idle_gaps(ops, 0.0, 5.0) == [(0.0, 1.0), (1.75, 3.0),
                                                 (4.0, 5.0)]
    tl = devtrace.DeviceTimeline(0.0, 5.0, ops)
    assert tl.kernel_seconds(0.0, 5.0) == pytest.approx(1.5)
    assert tl.top_ops(1) == [["k", 1.5]]
