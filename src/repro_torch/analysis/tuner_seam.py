"""Tuner-seam checker: launch configs must come from the tuning table.

The autotuner threads ``roofline.autotune.resolve_launch_config`` through
every count seam so one committed table governs every kernel launch.  A literal
``block_k=256`` / ``accum="mxu_f32"`` at a call site silently severs that
seam: the launch ignores the table, the sweep can no longer improve it, and
the exactness guard (MXU row bound re-checked at resolve time) is bypassed.

**TUNE001** flags calls into the counting entry points
(``itemset_counts``, ``itemset_counts_into``, ``streaming_counts``,
``distributed_counts``) that pass a LITERAL launch-config argument
(``block_k`` / ``block_n`` / ``accum`` / ``chunk_rows``) — directly, or
through a local name whose only assignment in the enclosing function is a
constant.  Forwarded parameters, ``None`` (resolve-inside), and values
derived from ``resolve_launch_config``/``resolve_serve_block_k`` are fine.

``roofline/`` itself is exempt: the sweep exists to measure explicit
configs, and benchmarks under ``benchmarks/`` are outside ``src/repro_torch``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence

from .engine import Checker, Finding, Module, call_name

_COUNT_ENTRYPOINTS = {"itemset_counts", "itemset_counts_into",
                      "streaming_counts", "distributed_counts"}
_CONFIG_KWARGS = {"block_k", "block_n", "accum", "chunk_rows"}


def _literal_value(node: ast.AST) -> Optional[object]:
    """The constant behind an expression, if it is one (ignoring None)."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.operand, ast.Constant):
        return node.operand.value
    return None


class TunerSeamChecker(Checker):
    name = "tuner_seam"
    codes = {
        "TUNE001": "literal launch-config argument at a count entry point "
                   "(bypasses resolve_launch_config / the tuning table)",
    }

    def __init__(self, exempt_prefixes: Sequence[str] = ("roofline/",)):
        self.exempt_prefixes = tuple(exempt_prefixes)

    def check_module(self, mod: Module) -> List[Finding]:
        if self.exempt_prefixes and mod.rel.startswith(self.exempt_prefixes):
            return []
        findings: List[Finding] = []

        def visit(node: ast.AST, consts: Dict[str, object]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = dict(consts)
                inner.update(self._local_constants(node))
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, ast.Call) and \
                    call_name(node) in _COUNT_ENTRYPOINTS:
                findings.extend(self._check_call(mod, node, consts))
            for child in ast.iter_child_nodes(node):
                visit(child, consts)

        visit(mod.tree, self._local_constants(mod.tree))
        return findings

    def _local_constants(self, scope: ast.AST) -> Dict[str, object]:
        consts: Dict[str, object] = {}
        assigned: Dict[str, int] = {}
        # shallow walk: nested function/class scopes resolve for themselves
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        assigned[tgt.id] = assigned.get(tgt.id, 0) + 1
                        val = _literal_value(node.value)
                        if val is not None:
                            consts[tgt.id] = val
            stack.extend(ast.iter_child_nodes(node))
        # only names assigned exactly once, to a constant, count as literal
        return {k: v for k, v in consts.items() if assigned.get(k) == 1}

    def _check_call(self, mod: Module, call: ast.Call,
                    local_consts: Dict[str, object]) -> List[Finding]:
        findings: List[Finding] = []
        for kw in call.keywords:
            if kw.arg not in _CONFIG_KWARGS:
                continue
            val = _literal_value(kw.value)
            origin = "literal"
            if val is None and isinstance(kw.value, ast.Name) and \
                    kw.value.id in local_consts:
                val = local_consts[kw.value.id]
                origin = f"local constant {kw.value.id!r}"
            if val is not None:
                findings.append(mod.finding(
                    call.lineno, "TUNE001",
                    f"{call_name(call)}(..., {kw.arg}={val!r}) passes a "
                    f"{origin} instead of threading "
                    f"resolve_launch_config", self.name))
        return findings
