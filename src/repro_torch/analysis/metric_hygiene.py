"""Metric hygiene checker: bounded label sets + consistent histogram grids.

The autotuner's ``geometry_bucket`` exists because telemetry labels derived
from request data (one distinct N per append, one distinct K per query
shape) grow the registry without bound.  This checker pins that discipline:

* **MET001** — a label keyword at a registry instrument call
  (``counter`` / ``gauge`` / ``set_gauge`` / ``histogram``) built from an
  obviously unbounded construction: an f-string, ``str()``/``repr()``/
  ``format()``, ``%``-/``+``-composed strings — directly or through a
  local name assigned from one.  Values routed through a bucketizer
  (any callee whose name contains ``bucket``) are exempt, as are plain
  constants and forwarded names (boundedness of a forwarded name is the
  caller's contract — e.g. the flusher's fixed trigger vocabulary).

* **MET002** — the same histogram name registered with two DIFFERENT
  explicit bucket grids anywhere in the tree.  The runtime
  ``MetricsRegistry.histogram`` raises on this at call time; the checker
  moves the failure to lint time, before one process ever hits both paths.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .engine import Checker, Finding, Module, call_name

_INSTRUMENT_METHODS = {"counter", "gauge", "set_gauge", "histogram"}
_NON_LABEL_KWARGS = {"buckets"}
_STRINGIFY_CALLS = {"str", "repr", "format"}


def _is_unbounded_expr(node: ast.AST) -> Optional[str]:
    """Why this label expression is unbounded, or None if it looks fine."""
    if isinstance(node, ast.JoinedStr):
        return "f-string label"
    if isinstance(node, ast.Call):
        cname = call_name(node)
        if cname is None:
            return None
        if "bucket" in cname.lower():
            return None   # routed through a bucketizer: bounded by design
        if cname in _STRINGIFY_CALLS:
            return f"{cname}() label"
        return None
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.Mod, ast.Add)):
        for side in (node.left, node.right):
            if isinstance(side, ast.Constant) and \
                    isinstance(side.value, str):
                return "string-composition label"
    return None


def _grid_literal(node: ast.AST) -> Optional[Tuple]:
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if not isinstance(e, ast.Constant):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


class MetricHygieneChecker(Checker):
    name = "metric_hygiene"
    codes = {
        "MET001": "unbounded metric label construction (not routed "
                  "through a bucketizer)",
        "MET002": "histogram name registered with conflicting bucket "
                  "grids",
    }

    def __init__(self):
        # name -> grid -> (rel, line) first witness
        self._grids: Dict[str, Dict[Tuple, Tuple[str, int]]] = {}
        self._mods: Dict[str, Module] = {}

    def check_module(self, mod: Module) -> List[Finding]:
        self._mods[mod.rel] = mod
        findings: List[Finding] = []

        def visit(node: ast.AST, consts: Dict[str, Optional[str]]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = dict(consts)
                inner.update(self._local_origins(node))
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _INSTRUMENT_METHODS:
                findings.extend(self._check_instrument(mod, node, consts))
            for child in ast.iter_child_nodes(node):
                visit(child, consts)

        visit(mod.tree, self._local_origins(mod.tree))
        return findings

    def _local_origins(self, scope: ast.AST) -> Dict[str, Optional[str]]:
        """name -> unboundedness reason for single-assignment locals
        (None value = assigned but from a bounded/unknown source)."""
        origins: Dict[str, Optional[str]] = {}
        counts: Dict[str, int] = {}
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        counts[tgt.id] = counts.get(tgt.id, 0) + 1
                        origins[tgt.id] = _is_unbounded_expr(node.value)
            stack.extend(ast.iter_child_nodes(node))
        return {k: v for k, v in origins.items() if counts.get(k) == 1}

    def _check_instrument(self, mod: Module, call: ast.Call,
                          consts: Dict[str, Optional[str]]) -> List[Finding]:
        findings: List[Finding] = []
        metric_name = None
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            metric_name = call.args[0].value
        for kw in call.keywords:
            if kw.arg is None or kw.arg in _NON_LABEL_KWARGS:
                if kw.arg == "buckets" and metric_name is not None and \
                        call.func.attr == "histogram":
                    grid = _grid_literal(kw.value)
                    if grid is not None:
                        self._grids.setdefault(metric_name, {}) \
                            .setdefault(grid, (mod.rel, call.lineno))
                continue
            reason = _is_unbounded_expr(kw.value)
            if reason is None and isinstance(kw.value, ast.Name):
                reason = consts.get(kw.value.id)
            if reason is not None:
                findings.append(mod.finding(
                    call.lineno, "MET001",
                    f"label {kw.arg}=... of metric "
                    f"{metric_name or '<dynamic>'} is a {reason}: the "
                    f"label set is unbounded — route it through the "
                    f"geometry bucketizer or a fixed vocabulary",
                    self.name))
        return findings

    def finalize(self) -> List[Finding]:
        findings: List[Finding] = []
        for name, grids in sorted(self._grids.items()):
            if len(grids) <= 1:
                continue
            sites = sorted(grids.values())
            rel, line = sites[-1]
            mod = self._mods.get(rel)
            msg = (f"histogram {name!r} registered with "
                   f"{len(grids)} different bucket grids "
                   f"(first at {sites[0][0]}:{sites[0][1]}) — "
                   f"MetricsRegistry will raise at runtime")
            if mod is not None:
                findings.append(mod.finding(line, "MET002", msg, self.name))
            else:
                findings.append(Finding(rel, line, "MET002", msg, self.name))
        return findings
