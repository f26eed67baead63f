"""Traced-scope safety checker: tracer leaks, bare asserts, host syncs.

The autotuner's contract is that launch configs resolve EAGERLY, on the
host, so that the values a compiled function specializes on stay concrete;
the flip side is that anything reaching a traced function body is
(potentially) a symbolic tensor, and Python-level control flow or scalar
conversion on one breaks the graph at trace time, recompiles per value, or
silently specializes.  This checker finds traced functions and flags:

* **JIT001** — ``float()``/``int()``/``bool()``/``.item()``/``.tolist()``
  on a traced argument (or a value derived from one) inside a traced scope;
* **JIT002** — Python branching (``if``/``while``/``assert``) whose test
  mentions a traced value;
* **JIT003** — a bare ``assert`` in a hot-path module (``kernels/``,
  ``mining/``, ``serve/``): it vanishes under ``python -O``, so invariants
  on user-reachable paths must be typed exceptions (the ``ops.py``
  precedent);
* **JIT004** — host syncs (``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, ``np.asarray``/``np.array`` on traced
  values) inside a traced scope.

Traced functions are PyTorch's and Triton's: those decorated with
``torch.compile`` (directly, called with options, or through
``functools.partial(torch.compile, ...)``), passed by name to a
``torch.compile(...)`` call, under ``torch.jit.script`` (decorated or passed
by name), and ``@triton.jit`` kernel bodies (Triton's counterpart of a
Pallas kernel body).  Statics are exempt from tainting: keyword-only
parameters (this repo's convention for statics — every kernel entry point
takes tensors positionally and config keyword-only), parameters annotated
with Python scalar types, and a Triton kernel's ``tl.constexpr``
parameters.  ``.shape``/``.ndim``/``.dtype``/``.size()``/``.dim()``/
``.numel()``/``len()`` of a traced tensor are concrete and break the taint.

Nothing outside a traced scope is flagged, apart from JIT003: an eager
``.item()`` is a host sync as much as ``np.asarray`` of a device array is,
and neither package lints eager code for it.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Checker, Finding, Module, attr_chain, call_name, names_in

_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str"}
_CAST_CALLS = {"float", "int", "bool"}
_HOST_SYNC_ATTRS = {"cpu", "numpy", "item", "tolist"}
_SHAPE_ATTRS = ("shape", "ndim", "dtype")
_SHAPE_CALLS = ("len", "size", "dim", "numel")


def _traced_by(chain: Optional[Tuple[str, ...]]) -> Optional[str]:
    """Which tracer an attribute chain names (``torch.compile``,
    ``torch.jit.script``, ``triton.jit``), or None."""
    if chain is None or len(chain) < 2:
        return None
    if chain[-1] == "compile" and chain[-2] == "torch":
        return "torch.compile"
    if chain[-2:] == ("jit", "script"):
        return "torch.jit.script"
    if chain[-1] == "jit" and chain[-2] == "triton":
        return "triton.jit"
    return None


def _decorator_tracer(dec: ast.AST) -> Optional[str]:
    """The tracer this decorator applies, or None."""
    why = _traced_by(attr_chain(dec))
    if why is not None:
        return why
    if isinstance(dec, ast.Call):
        why = _traced_by(attr_chain(dec.func))
        if why is not None:
            return why
        # functools.partial(torch.compile, mode=...)
        fn_chain = attr_chain(dec.func)
        if fn_chain is not None and fn_chain[-1] == "partial" and dec.args:
            return _traced_by(attr_chain(dec.args[0]))
    return None


def _is_static(arg: ast.arg) -> bool:
    """Scalar-annotated, or a Triton ``tl.constexpr`` parameter."""
    ann = arg.annotation
    if getattr(ann, "id", None) in _SCALAR_ANNOTATIONS:
        return True
    chain = attr_chain(ann) if ann is not None else None
    return chain is not None and chain[-1] == "constexpr"


class JitSafetyChecker(Checker):
    name = "jit_safety"
    codes = {
        "JIT001": "Python scalar conversion of a traced value in a traced "
                  "scope (graph break, recompile or silent specialization)",
        "JIT002": "Python branching on a traced value in a traced scope",
        "JIT003": "bare assert in a hot-path module (vanishes under "
                  "python -O; use a typed exception with context)",
        "JIT004": "host sync inside a traced scope",
    }

    def __init__(self,
                 hot_prefixes: Sequence[str] = ("kernels/", "mining/",
                                                "serve/")):
        self.hot_prefixes = tuple(hot_prefixes)

    def check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for func, why in self._find_traced_functions(mod):
            findings.extend(self._check_traced_body(mod, func, why))
        if mod.rel.startswith(self.hot_prefixes) or \
                self.hot_prefixes == ("",):
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assert):
                    findings.append(mod.finding(
                        node.lineno, "JIT003",
                        "bare assert on a hot path: disabled under "
                        "python -O — raise a typed exception with "
                        "geometry/context instead", self.name))
        return findings

    # -- traced function discovery -------------------------------------------

    def _find_traced_functions(self, mod: Module):
        by_name: Dict[str, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, node)

        out = []
        seen: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    tracer = _decorator_tracer(dec)
                    if tracer is not None and node.name not in seen:
                        seen.add(node.name)
                        what = ("Triton kernel body" if tracer == "triton.jit"
                                else f"decorated with {tracer}")
                        out.append((node, what))
                        break
            elif isinstance(node, ast.Call):
                tracer = _traced_by(attr_chain(node.func))
                if tracer in ("torch.compile", "torch.jit.script") and \
                        node.args and isinstance(node.args[0], ast.Name):
                    target = by_name.get(node.args[0].id)
                    if target is not None and target.name not in seen:
                        seen.add(target.name)
                        out.append((target, f"passed to {tracer}(...)"))
        return out

    # -- body analysis --------------------------------------------------------

    def _check_traced_body(self, mod: Module, func: ast.AST,
                           why: str) -> List[Finding]:
        tainted: Set[str] = set()
        args = func.args
        for a in args.args + args.posonlyargs:
            if a.arg == "self" or _is_static(a):
                continue
            tainted.add(a.arg)
        # keyword-only params are this repo's static-config convention
        # (block_k / accum / n_words are bound concrete before tracing)

        findings: List[Finding] = []

        def is_tainted(expr: ast.AST) -> bool:
            return bool(names_in(expr) & tainted)

        def breaks_taint(expr: ast.AST) -> bool:
            """Concrete-at-trace-time projections of a traced tensor."""
            if isinstance(expr, ast.Attribute) and expr.attr in _SHAPE_ATTRS:
                return True
            if isinstance(expr, ast.Subscript):
                return breaks_taint(expr.value)
            if isinstance(expr, ast.Call) and \
                    call_name(expr) in _SHAPE_CALLS:
                return True
            if isinstance(expr, ast.Tuple):
                return all(breaks_taint(e) for e in expr.elts)
            return False

        class V(ast.NodeVisitor):
            # nested defs are closures traced with their parent: the default
            # generic_visit recurses into them

            def visit_Assign(self, node):
                if is_tainted(node.value) and not breaks_taint(node.value):
                    for tgt in node.targets:
                        tainted.update(names_in(tgt))
                self.generic_visit(node)

            def visit_Call(self, node):
                cname = call_name(node)
                chain = attr_chain(node.func) or ()
                if cname in _CAST_CALLS and node.args and \
                        is_tainted(node.args[0]):
                    findings.append(mod.finding(
                        node.lineno, "JIT001",
                        f"{cname}() on traced value in {func.name} "
                        f"({why})", JitSafetyChecker.name))
                elif cname in ("asarray", "array") and node.args and \
                        is_tainted(node.args[0]) and \
                        chain[:1] in (("np",), ("numpy",)):
                    findings.append(mod.finding(
                        node.lineno, "JIT004",
                        f"host transfer {'.'.join(chain)}() on traced "
                        f"value in {func.name} ({why})",
                        JitSafetyChecker.name))
                elif chain[-2:] == ("cuda", "synchronize"):
                    findings.append(mod.finding(
                        node.lineno, "JIT004",
                        f"{'.'.join(chain)}() in {func.name} ({why})",
                        JitSafetyChecker.name))
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _HOST_SYNC_ATTRS and \
                        is_tainted(node.func.value):
                    code = "JIT001" if node.func.attr in ("item", "tolist") \
                        else "JIT004"
                    findings.append(mod.finding(
                        node.lineno, code,
                        f".{node.func.attr}() on traced value in "
                        f"{func.name} ({why})", JitSafetyChecker.name))
                self.generic_visit(node)

            def visit_If(self, node):
                if is_tainted(node.test):
                    findings.append(mod.finding(
                        node.lineno, "JIT002",
                        f"Python `if` on traced value in {func.name} "
                        f"({why}) — use torch.where / tl.where",
                        JitSafetyChecker.name))
                self.generic_visit(node)

            def visit_While(self, node):
                if is_tainted(node.test):
                    findings.append(mod.finding(
                        node.lineno, "JIT002",
                        f"Python `while` on traced value in {func.name} "
                        f"({why})", JitSafetyChecker.name))
                self.generic_visit(node)

            def visit_Assert(self, node):
                if is_tainted(node.test):
                    findings.append(mod.finding(
                        node.lineno, "JIT002",
                        f"assert on traced value in {func.name} ({why})",
                        JitSafetyChecker.name))
                self.generic_visit(node)

        for stmt in func.body:
            V().visit(stmt)
        return findings
