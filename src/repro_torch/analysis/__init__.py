"""repro-lint: repo-specific static analysis for this codebase's invariants.

Five checkers over the serving/mining/kernel stack (see each module's
docstring for the rule catalogue), a small AST engine with suppression
comments and a committed baseline, and an advisory dead-module import
report.  Driven by ``python -m repro_torch.launch.analyze``; gated in
``tools/ci_torch.sh``; the dynamic twin of the concurrency rules lives in
``repro_torch.obs.lockwatch``.

Stdlib-only by design — the analyzer must be runnable before the heavy
imports it polices.
"""
from __future__ import annotations

from typing import List

from .engine import (Checker, Finding, Module, analyze_paths, find_cycle,
                     load_baseline, new_findings, write_baseline)
from .concurrency import ConcurrencyChecker
from .exception_hygiene import ExceptionHygieneChecker
from .jit_safety import JitSafetyChecker
from .metric_hygiene import MetricHygieneChecker
from .tuner_seam import TunerSeamChecker
from .deadmods import dead_module_report

__all__ = [
    "Checker", "Finding", "Module", "analyze_paths", "find_cycle",
    "load_baseline", "new_findings", "write_baseline",
    "ConcurrencyChecker", "ExceptionHygieneChecker", "JitSafetyChecker",
    "MetricHygieneChecker", "TunerSeamChecker", "default_checkers",
    "dead_module_report",
]


def default_checkers() -> List[Checker]:
    """Fresh instances of the five repo checkers (checkers are stateful
    across one run — never share instances between runs)."""
    return [
        ConcurrencyChecker(),
        JitSafetyChecker(),
        TunerSeamChecker(),
        MetricHygieneChecker(),
        ExceptionHygieneChecker(),
    ]
