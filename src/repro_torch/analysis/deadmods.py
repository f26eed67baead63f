"""Dead-module report: src/repro_torch files unreachable from any entry
point.

Advisory output (never a CI gate): builds the static import graph of
``src/repro_torch`` and marks every module reachable from the roots — the
``repro_torch.launch`` entry points plus anything imported by ``tests/``,
``tools/`` or ``examples/``, or by ``chip_smoke.py`` (the only user of
``kernels/itemset_count/b1_probe.py``).  What's left is code nothing
references, listed so that it can be deleted or revived deliberately rather
than left to rot silently.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Set

from .engine import iter_py_files

_PKG = "repro_torch"


def module_map(src_root: str) -> Dict[str, str]:
    """Dotted module name -> path for every module under ``src_root``
    (which is the directory CONTAINING the ``repro_torch`` package)."""
    out: Dict[str, str] = {}
    pkg_root = os.path.join(src_root, _PKG)
    for path in iter_py_files(pkg_root):
        rel = os.path.relpath(path, src_root)
        parts = rel[:-3].split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


def _module_package(modname: str, path: str) -> str:
    """The package a module's relative imports resolve against."""
    if path.endswith("__init__.py"):
        return modname
    return modname.rsplit(".", 1)[0] if "." in modname else ""


def imports_of(path: str, modname: str, known: Set[str]) -> Set[str]:
    """Known-module names imported by one file (absolute + relative)."""
    with open(path, "r", encoding="utf-8") as fh:
        try:
            tree = ast.parse(fh.read(), filename=path)
        except SyntaxError:
            return set()
    pkg = _module_package(modname, path) if modname else ""
    found: Set[str] = set()

    def note(dotted: str) -> None:
        # credit the module and every enclosing package __init__
        parts = dotted.split(".")
        for i in range(1, len(parts) + 1):
            cand = ".".join(parts[:i])
            if cand in known:
                found.add(cand)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                note(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                up = pkg.split(".") if pkg else []
                if node.level - 1 > 0:
                    up = up[:-(node.level - 1)] if node.level - 1 <= len(up) \
                        else []
                base = ".".join(up + ([node.module] if node.module else []))
            if base:
                note(base)
                for alias in node.names:
                    note(f"{base}.{alias.name}")
    return found


def dead_module_report(repo_root: str) -> dict:
    """``{"roots": [...], "reachable": [...], "dead": [...]}`` over
    ``src/repro_torch``."""
    src_root = os.path.join(repo_root, "src")
    known = module_map(src_root)
    names = set(known)

    edges: Dict[str, Set[str]] = {
        name: imports_of(path, name, names) for name, path in known.items()
    }

    roots: Set[str] = {n for n in names if n == f"{_PKG}.launch"
                       or n.startswith(f"{_PKG}.launch.")}
    for sub in ("tests", "tools", "examples"):
        d = os.path.join(repo_root, sub)
        if not os.path.isdir(d):
            continue
        for path in iter_py_files(d):
            roots |= imports_of(path, "", names)
    smoke = os.path.join(repo_root, "chip_smoke.py")
    if os.path.isfile(smoke):
        roots |= imports_of(smoke, "", names)

    reachable: Set[str] = set()
    frontier = sorted(roots)
    while frontier:
        mod = frontier.pop()
        if mod in reachable:
            continue
        reachable.add(mod)
        frontier.extend(sorted(edges.get(mod, ()) - reachable))

    dead = sorted(names - reachable)
    return {
        "roots": sorted(roots),
        "reachable": sorted(reachable),
        "dead": dead,
        "dead_paths": [os.path.relpath(known[m], repo_root) for m in dead],
    }
