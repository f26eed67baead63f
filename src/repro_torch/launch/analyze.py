"""repro-lint over the port: run the static-analysis checkers, gate on the
committed baseline, self-test the detectors, and report dead modules.

  python -m repro_torch.launch.analyze                    # gate: fail on new
                                                          # findings
  python -m repro_torch.launch.analyze --update-baseline  # accept current
                                                          # findings
  python -m repro_torch.launch.analyze --json out.json    # machine-readable
                                                          # report
  python -m repro_torch.launch.analyze --self-test        # prove detectors
                                                          # catch injected
                                                          # violations
  python -m repro_torch.launch.analyze --dead-modules     # advisory import-
                                                          # graph report
                                                          # (always exit 0)

The twin of the JAX package's ``tools/analyze.py``, with the same flags.
``--root`` defaults to ``src/repro_torch``.  The baseline
(``src/repro_torch/analysis/baseline.json``) holds line-number-free
fingerprints of accepted findings; anything not in it fails the run.  The
shipped tree keeps the baseline EMPTY — suppressions with a rationale
comment are preferred over baselining, because they live next to the code
they excuse.  Stdlib only: the lint runs before any heavy import.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.analysis import (analyze_paths, default_checkers,
                                  dead_module_report, engine)

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(os.path.dirname(PKG_ROOT))
DEFAULT_ROOT = PKG_ROOT
DEFAULT_BASELINE = os.path.join(PKG_ROOT, "analysis", "baseline.json")

# One injected violation per checker: the self-test writes these into a
# temp tree and requires every checker to catch its own (and to stay quiet
# on the clean twin).
_SELFTEST_VIOLATIONS = {
    "concurrency": (
        "CONC001",
        """\
import threading

class TwoLocks:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        threading.Thread(target=self._run).start()

    def forward(self):
        with self._a_lock:
            with self._b_lock:
                self.counter = 1

    def _run(self):
        with self._b_lock:
            with self._a_lock:
                self.counter = 2
"""),
    "jit_safety": (
        "JIT001",
        """\
import torch

@torch.compile
def bad(x):
    if x > 0:
        return float(x)
    return x
"""),
    "tuner_seam": (
        "TUNE001",
        """\
def launch(tx, tgt, w, itemset_counts):
    return itemset_counts(tx, tgt, w, block_k=256, accum="mxu_f32")
"""),
    "metric_hygiene": (
        "MET001",
        """\
def record(REGISTRY, n):
    REGISTRY.counter("rows_total", rows=f"{n}").inc()
"""),
    "exception_hygiene": (
        "EXC001",
        """\
def swallow(fn):
    try:
        fn()
    except Exception:
        pass
"""),
}

_SELFTEST_CLEAN = """\
import threading

class OneLock:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1
"""


def run_gate(args) -> int:
    findings, n_files = analyze_paths([args.root], default_checkers(),
                                      root=args.root)
    baseline = engine.load_baseline(args.baseline)
    new = engine.new_findings(findings, baseline)
    known = len(findings) - len(new)

    if args.update_baseline:
        n = engine.write_baseline(args.baseline, findings)
        print(f"repro-lint: baseline updated: {n} fingerprint(s) "
              f"-> {os.path.relpath(args.baseline, REPO_ROOT)}")
        return 0

    if args.json:
        doc = {
            "files": n_files,
            "baselined": known,
            "new": [f.__dict__ for f in new],
            "all": [f.__dict__ for f in findings],
        }
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=1)
            fh.write("\n")

    for f in new:
        print(f.format())
    status = "FAIL" if new else "ok"
    print(f"repro-lint: {status}: {n_files} files, {len(new)} new "
          f"finding(s), {known} baselined")
    return 1 if new else 0


def run_self_test() -> int:
    failures = []
    with tempfile.TemporaryDirectory(prefix="repro_lint_selftest_") as tmp:
        # files live under serve/ so the path-scoped checkers (concurrency
        # watches serve/ + obs/) see them
        os.makedirs(os.path.join(tmp, "serve"))
        for checker_name, (code, source) in _SELFTEST_VIOLATIONS.items():
            path = os.path.join(tmp, "serve", f"bad_{checker_name}.py")
            with open(path, "w") as fh:
                fh.write(source)
        clean_path = os.path.join(tmp, "clean.py")
        with open(clean_path, "w") as fh:
            fh.write(_SELFTEST_CLEAN)

        findings, _ = analyze_paths([tmp], default_checkers(), root=tmp)
        by_file = {}
        for f in findings:
            by_file.setdefault(f.path, set()).add(f.code)

        for checker_name, (code, _) in _SELFTEST_VIOLATIONS.items():
            got = by_file.get(f"serve/bad_{checker_name}.py", set())
            if code in got:
                print(f"self-test: {checker_name}: caught injected "
                      f"{code} [ok]")
            else:
                failures.append(f"{checker_name}: injected {code} NOT "
                                f"caught (got {sorted(got) or 'nothing'})")
        if by_file.get("clean.py"):
            failures.append(f"clean twin flagged: "
                            f"{sorted(by_file['clean.py'])}")
        else:
            print("self-test: clean twin unflagged [ok]")

    for msg in failures:
        print(f"self-test: FAIL: {msg}")
    print(f"repro-lint self-test: "
          f"{'FAIL' if failures else 'ok'} "
          f"({len(_SELFTEST_VIOLATIONS)} injected violations)")
    return 1 if failures else 0


def run_dead_modules() -> int:
    rep = dead_module_report(REPO_ROOT)
    print(f"dead-module report (advisory): "
          f"{len(rep['reachable'])} reachable from "
          f"{len(rep['roots'])} roots; {len(rep['dead'])} unreferenced:")
    for path in rep["dead_paths"]:
        print(f"  {path}")
    if not rep["dead"]:
        print("  (none)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="tree to analyze (default: src/repro_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--self-test", action="store_true",
                    help="verify every checker catches an injected "
                         "violation")
    ap.add_argument("--dead-modules", action="store_true",
                    help="advisory import-graph report (always exits 0)")
    args = ap.parse_args(argv)

    if args.self_test:
        return run_self_test()
    if args.dead_modules:
        return run_dead_modules()
    return run_gate(args)


if __name__ == "__main__":
    sys.exit(main())
