"""repro-lint engine: AST analysis over this repo's own invariants.

Generic linters can't see that every count seam must thread
``resolve_launch_config``, that metric label sets must stay bounded through
the geometry bucketizer, or which attributes the ``AsyncFlusher`` thread
shares with its server — so this package encodes those rules directly.
The engine is deliberately small:

  * :class:`Module` — one parsed source file (AST + raw lines + the
    suppression comments found in it);
  * :class:`Checker` — the protocol every rule module implements:
    ``check_module(mod)`` per file, then ``finalize()`` for cross-file
    facts (lock graphs, histogram grids);
  * :class:`Finding` — one violation, with a LINE-NUMBER-FREE fingerprint
    (path + code + stripped source line) so committed baselines survive
    unrelated edits above the finding;
  * baseline load/diff/write helpers for ``repro_torch.launch.analyze``.

Suppression syntax (same line as the finding)::

    something_flagged()   # repro-lint: disable=CONC002  -- why it is safe

or, anywhere in a file, ``# repro-lint: disable-file=JIT003`` (code list,
or ``all``).  Suppressions are for invariants the checker cannot see
statically (e.g. "caller holds the lock"); the comment should say why.

Stdlib-only: the analyzer must run in CI before any
heavyweight import succeeds.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_SUPPRESS_LINE_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_*,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*repro-lint:\s*disable-file=([A-Za-z0-9_*,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    path: str       # repo-relative posix path (fingerprint component)
    line: int       # 1-based; NOT part of the fingerprint
    code: str       # e.g. "CONC001"
    message: str
    checker: str    # checker name that produced it
    context: str = ""   # stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> str:
        return f"{self.path}::{self.code}::{self.context}"

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.checker}] " \
               f"{self.message}"


class Module:
    """One parsed source file plus its suppression directives."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        for i, ln in enumerate(self.lines, 1):
            m = _SUPPRESS_FILE_RE.search(ln)
            if m:
                self.file_suppressions |= _parse_codes(m.group(1))
                continue
            m = _SUPPRESS_LINE_RE.search(ln)
            if m:
                codes = _parse_codes(m.group(1))
                self.line_suppressions.setdefault(i, set()).update(codes)
                if ln.strip().startswith("#"):
                    # own-line directive: applies to the next line too
                    self.line_suppressions.setdefault(i + 1,
                                                      set()).update(codes)

    def context_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, line: int, code: str, message: str,
                checker: str) -> Finding:
        return Finding(self.rel, line, code, message, checker,
                       self.context_line(line))

    def suppressed(self, f: Finding) -> bool:
        if _matches(self.file_suppressions, f.code):
            return True
        return _matches(self.line_suppressions.get(f.line, set()), f.code)


def _parse_codes(raw: str) -> Set[str]:
    return {c.strip() for c in raw.split(",") if c.strip()}


def _matches(codes: Set[str], code: str) -> bool:
    return bool(codes) and (code in codes or "all" in codes or "*" in codes)


class Checker:
    """Base checker: subclass, set ``name``/``codes``, override hooks.

    Checkers are STATEFUL across one run (``finalize`` sees facts collected
    from every module), so callers must construct fresh instances per run
    (see :func:`repro_torch.analysis.default_checkers`).
    """

    name = "checker"
    codes: Dict[str, str] = {}

    def check_module(self, mod: Module) -> List[Finding]:
        return []

    def finalize(self) -> List[Finding]:
        return []


def iter_py_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(".") and d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def analyze_paths(paths: Sequence[str], checkers: Sequence[Checker],
                  root: Optional[str] = None) -> Tuple[List[Finding], int]:
    """Run ``checkers`` over every ``.py`` under ``paths``.

    Returns ``(findings, n_files)`` with suppressions already applied and
    findings sorted by location.  ``root`` anchors the repo-relative paths
    used in fingerprints (defaults to each path's own directory root).
    """
    files: List[Tuple[str, str]] = []   # (abspath, rel)
    for p in paths:
        if os.path.isdir(p):
            base = root or p
            for f in iter_py_files(p):
                files.append((f, os.path.relpath(f, base)))
        else:
            base = root or os.path.dirname(p) or "."
            files.append((p, os.path.relpath(p, base)))

    modules: List[Module] = []
    findings: List[Finding] = []
    for path, rel in files:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            modules.append(Module(path, rel, source))
        except SyntaxError as e:
            findings.append(Finding(rel.replace(os.sep, "/"),
                                    e.lineno or 0, "ENG001",
                                    f"syntax error: {e.msg}", "engine"))

    by_rel = {m.rel: m for m in modules}
    for checker in checkers:
        raw: List[Finding] = []
        for mod in modules:
            raw.extend(checker.check_module(mod))
        raw.extend(checker.finalize())
        for f in raw:
            mod = by_rel.get(f.path)
            if mod is not None and mod.suppressed(f):
                continue
            findings.append(f)

    findings.sort(key=lambda f: (f.path, f.line, f.code, f.message))
    return findings, len(modules)


# -- baseline ----------------------------------------------------------------

BASELINE_SCHEMA = 1


def load_baseline(path: str) -> Set[str]:
    """Fingerprint set from a committed baseline file (empty if absent)."""
    if not os.path.isfile(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"unsupported baseline schema in {path}: "
                         f"{doc.get('schema')!r}")
    return set(doc.get("fingerprints", []))


def write_baseline(path: str, findings: Iterable[Finding]) -> int:
    fps = sorted({f.fingerprint for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema": BASELINE_SCHEMA, "fingerprints": fps}, fh,
                  indent=1)
        fh.write("\n")
    return len(fps)


def new_findings(findings: Sequence[Finding],
                 baseline: Set[str]) -> List[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


# -- shared AST helpers (used by several checkers) ---------------------------

def attr_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``self._server._lock`` -> ("self", "_server", "_lock"); None if the
    expression is not a pure Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """Bare callee name of a call: ``f(...)`` -> "f", ``a.b.f(...)`` -> "f"."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    """First cycle in a directed graph as a node list (closed: first ==
    last), or None.  Iterative DFS with the standard three-color marking."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {u: WHITE for u in edges}
    for vs in edges.values():
        for v in vs:
            color.setdefault(v, WHITE)
    for start in sorted(color):
        if color[start] != WHITE:
            continue
        stack: List[Tuple[str, Iterable[str]]] = \
            [(start, iter(sorted(edges.get(start, ()))))]
        color[start] = GRAY
        path = [start]
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color[nxt] == GRAY:
                    return path[path.index(nxt):] + [nxt]
                if color[nxt] == WHITE:
                    color[nxt] = GRAY
                    path.append(nxt)
                    stack.append((nxt, iter(sorted(edges.get(nxt, ())))))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                path.pop()
                stack.pop()
    return None
