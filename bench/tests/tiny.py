"""A throwaway copy of the benchmark at sizes a CPU test run holds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the cells' sizes, cut so that a run on the CPU takes seconds
TINY = {
    "configs/sim-1m.json": dict(n_transactions=3000, n_items=20, p_y=0.1,
                                min_support=0.01),
    "configs/census-adult.json": dict(n_rows=3000, p_y=0.05,
                                      min_support=0.005),
    "traffic/mine-jobs.json": dict(warmup_rows=500),
    "traffic/count-open-cold.json": dict(rate_per_s=60, check_requests=40,
                                         answer_wait_s=20, warmup_seconds=0.5),
    "traffic/count-open-hot.json": dict(rate_per_s=60, check_requests=40,
                                        answer_wait_s=20, catalogue=300,
                                        warmup_seconds=0.5),
}


def edit_json(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


def tiny_checkout(dest: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``bench/`` under ``dest`` with every
    configuration and mix cut to a CPU test's size; returns the copy's
    root."""
    root = dest / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for rel, changes in TINY.items():
        edit_json(root / "bench" / rel, **changes)
    return root
