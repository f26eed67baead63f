"""Concurrency checker: lock-acquisition graph + thread-shared attributes.

Two rules over the threaded serving surface (``serve/`` + ``obs/``):

* **CONC001 — inconsistent lock ordering.**  Every ``with <lock>:`` scope
  contributes edges held-lock -> newly-acquired-lock; calls made while
  holding a lock contribute edges to every lock the (transitively resolved)
  callee may acquire.  A cycle in the resulting graph means two code paths
  acquire the same locks in opposite orders — the classic ABBA deadlock.
  The dynamic twin of this rule is ``repro_torch.obs.lockwatch``, which records
  the orders an actual threaded run exercised.

* **CONC002 — shared attribute mutated outside a held lock.**  For every
  class that starts a ``threading.Thread(target=self.<m>)``, any attribute
  ASSIGNED inside the thread-target method (or a same-class method it
  calls) is thread-shared; assigning it anywhere in the class outside a
  ``with <lock>:`` scope is a data race.  ``__init__`` is exempt — the
  thread cannot observe construction.  Methods documented as "called under
  the caller's lock" carry an explicit suppression naming that contract.

Static call resolution is deliberately conservative: ``self.m()`` resolves
inside the class; bare ``f()`` resolves to module-level functions of any
analyzed module; ``obj.m()`` resolves by method name across analyzed
classes UNLESS the name collides with a builtin container method
(``append``, ``get``, ...) — a ``list.append`` must not inherit
``CountServer.append``'s lock footprint.  Cross-object attribute locks that
static analysis cannot type (the flusher touching its server's lock) are
resolved through an explicit alias table.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Checker, Finding, Module, attr_chain, find_cycle

# Attribute chains (joined with ".") whose lock identity crosses objects in
# a way the AST cannot see.  Keyed on the source text of the with-item.
DEFAULT_LOCK_ALIASES = {
    "self._server._lock": "CountServer._lock",   # AsyncFlusher -> its server
    "self.server._lock": "CountServer._lock",    # RuleServer -> its server
    # the composed backend / background compactor acquire their store's lock
    "self.store._store_lock": "VersionedDB._store_lock",
    "self._store._store_lock": "VersionedDB._store_lock",
    "store._store_lock": "VersionedDB._store_lock",   # store = self.store
}

# Method names that collide with builtin container/primitive methods: calls
# through an arbitrary receiver must NOT resolve to same-named methods of
# analyzed classes (e.g. list.append vs CountServer.append).
_BUILTIN_METHODS = frozenset({
    "append", "appendleft", "add", "get", "pop", "popleft", "clear",
    "update", "extend", "remove", "insert", "discard", "sort", "reverse",
    "copy", "count", "index", "items", "keys", "values", "setdefault",
    "join", "split", "strip", "format", "encode", "decode", "read",
    "write", "flush", "acquire", "release", "wait", "notify", "notify_all",
    "set", "is_set", "put", "get_nowait", "start",
})

_LOCKISH_RE = ("lock", "mutex", "_mu")


def _is_lock_factory(node: ast.AST) -> bool:
    """Does this expression construct a threading lock anywhere inside?
    (Covers ``threading.RLock() if async_flush else nullcontext()``.)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name in ("Lock", "RLock"):
                return True
    return False


def _looks_lockish(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _LOCKISH_RE)


class _FuncFacts:
    """Per-function facts: direct acquisitions, lock-order events, call
    sites made while holding locks, and attribute assignments."""

    def __init__(self, key: str):
        self.key = key
        self.acquires: Set[str] = set()
        # (held_tuple, acquired, line)
        self.events: List[Tuple[Tuple[str, ...], str, int]] = []
        # (held_tuple, kind, callee, line); kind in {"self", "free", "method"}
        self.calls: List[Tuple[Tuple[str, ...], str, str, int]] = []
        # (attr, under_lock, line) for ``self.X = ...`` / ``self.X += ...``
        self.self_assigns: List[Tuple[str, bool, int]] = []


class ConcurrencyChecker(Checker):
    name = "concurrency"
    codes = {
        "CONC001": "inconsistent lock acquisition order (cycle in the "
                   "lock-order graph)",
        "CONC002": "thread-shared attribute mutated outside a held lock",
    }

    def __init__(self,
                 path_prefixes: Sequence[str] = ("serve/", "obs/",
                                                 "mining/spill.py"),
                 aliases: Optional[Dict[str, str]] = None):
        self.path_prefixes = tuple(path_prefixes)
        self.aliases = dict(DEFAULT_LOCK_ALIASES if aliases is None
                            else aliases)
        self._mods: Dict[str, Module] = {}
        # facts keyed by (class_or_None, func_name) -> list (same name may
        # repeat across modules; merged conservatively)
        self._class_funcs: Dict[Tuple[str, str], List[_FuncFacts]] = {}
        self._free_funcs: Dict[str, List[_FuncFacts]] = {}
        self._findings: List[Finding] = []
        self.lock_edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    # -- per-module collection ------------------------------------------------

    def check_module(self, mod: Module) -> List[Finding]:
        if self.path_prefixes != ("",) and \
                not mod.rel.startswith(self.path_prefixes):
            return []
        self._mods[mod.rel] = mod
        module_locks = self._module_level_locks(mod)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(mod, node, module_locks)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                facts = self._collect_function(mod, node, cls=None,
                                               lock_attrs={},
                                               module_locks=module_locks)
                self._free_funcs.setdefault(node.name, []).append(facts)
        return []

    def _module_level_locks(self, mod: Module) -> Dict[str, str]:
        base = mod.rel.rsplit("/", 1)[-1].rsplit(".", 1)[0]
        locks: Dict[str, str] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_factory(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        locks[tgt.id] = f"{base}.{tgt.id}"
        return locks

    def _collect_class(self, mod: Module, cls: ast.ClassDef,
                       module_locks: Dict[str, str]) -> None:
        lock_attrs: Dict[str, str] = {}
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and _is_lock_factory(sub.value):
                for tgt in sub.targets:
                    chain = attr_chain(tgt)
                    if chain and len(chain) == 2 and chain[0] == "self":
                        lock_attrs[chain[1]] = f"{cls.name}.{chain[1]}"

        thread_targets: Set[str] = set()
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Call):
                fn = sub.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    fn.id if isinstance(fn, ast.Name) else None
                if name != "Thread":
                    continue
                for kw in sub.keywords:
                    if kw.arg == "target":
                        chain = attr_chain(kw.value)
                        if chain and len(chain) == 2 and chain[0] == "self":
                            thread_targets.add(chain[1])

        methods: Dict[str, _FuncFacts] = {}
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                facts = self._collect_function(mod, node, cls=cls.name,
                                               lock_attrs=lock_attrs,
                                               module_locks=module_locks)
                methods[node.name] = facts
                self._class_funcs.setdefault((cls.name, node.name),
                                             []).append(facts)

        if thread_targets:
            self._check_shared_attrs(mod, cls.name, methods, thread_targets)

    def _check_shared_attrs(self, mod: Module, cls_name: str,
                            methods: Dict[str, _FuncFacts],
                            thread_targets: Set[str]) -> None:
        # thread-owned methods: closure of the targets under self-calls
        owned = set(thread_targets)
        frontier = list(thread_targets)
        while frontier:
            m = frontier.pop()
            facts = methods.get(m)
            if facts is None:
                continue
            for _, kind, callee, _ in facts.calls:
                if kind == "self" and callee in methods and \
                        callee not in owned:
                    owned.add(callee)
                    frontier.append(callee)
        # calls list only records lock-held call sites; also walk unheld
        # self-calls for ownership (a thread method may call helpers while
        # holding nothing)
        changed = True
        while changed:
            changed = False
            for m in list(owned):
                facts = methods.get(m)
                if facts is None:
                    continue
                for _, kind, callee, _ in facts.all_calls:
                    if kind == "self" and callee in methods and \
                            callee not in owned:
                        owned.add(callee)
                        changed = True

        shared: Set[str] = set()
        for m in owned:
            facts = methods.get(m)
            if facts is None:
                continue
            shared |= {attr for attr, _, _ in facts.self_assigns}
        if not shared:
            return
        for mname, facts in methods.items():
            if mname == "__init__":
                continue   # pre-start construction: thread can't observe it
            for attr, under_lock, line in facts.self_assigns:
                if attr in shared and not under_lock:
                    self._findings.append(mod.finding(
                        line, "CONC002",
                        f"{cls_name}.{attr} is assigned by the "
                        f"thread target (Thread(target=self."
                        f"{'/'.join(sorted(thread_targets))})) but mutated "
                        f"here outside any held lock", self.name))

    def _collect_function(self, mod: Module, func: ast.AST, cls: Optional[str],
                          lock_attrs: Dict[str, str],
                          module_locks: Dict[str, str]) -> _FuncFacts:
        key = f"{mod.rel}:{cls + '.' if cls else ''}{func.name}"
        facts = _FuncFacts(key)
        facts.all_calls = []   # (held, kind, callee, line) incl. unheld
        checker = self

        def resolve_lock(expr: ast.AST) -> Optional[str]:
            chain = attr_chain(expr)
            if chain is None:
                return None
            text = ".".join(chain)
            if text in checker.aliases:
                return checker.aliases[text]
            if len(chain) == 2 and chain[0] == "self":
                if chain[1] in lock_attrs:
                    return lock_attrs[chain[1]]
                if _looks_lockish(chain[1]):
                    return f"{cls or mod.rel}.{chain[1]}"
                return None
            if len(chain) == 1:
                if chain[0] in module_locks:
                    return module_locks[chain[0]]
                if _looks_lockish(chain[0]):
                    return f"{mod.rel}:{chain[0]}"
                return None
            # deeper chain (other object's lock): only lockish tails count
            if _looks_lockish(chain[-1]):
                return f"?{text}"
            return None

        held: List[str] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not func:
                return   # nested defs: separate execution context
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in node.items:
                    lock = resolve_lock(item.context_expr)
                    if lock is not None:
                        facts.acquires.add(lock)
                        for h in held:
                            if h != lock:
                                facts.events.append(
                                    (tuple(held), lock, node.lineno))
                                break
                        held.append(lock)
                        acquired.append(lock)
                    else:
                        visit(item.context_expr)
                for stmt in node.body:
                    visit(stmt)
                for _ in acquired:
                    held.pop()
                return
            if isinstance(node, ast.Call):
                kind = None
                callee = None
                if isinstance(node.func, ast.Name):
                    kind, callee = "free", node.func.id
                elif isinstance(node.func, ast.Attribute):
                    recv = node.func.value
                    if isinstance(recv, ast.Name) and recv.id == "self":
                        kind, callee = "self", node.func.attr
                    else:
                        kind, callee = "method", node.func.attr
                if callee is not None:
                    rec = (tuple(held), kind, callee, node.lineno)
                    facts.all_calls.append(rec)
                    if held:
                        facts.calls.append(rec)
                for child in ast.iter_child_nodes(node):
                    visit(child)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    chain = attr_chain(tgt)
                    if chain and len(chain) == 2 and chain[0] == "self":
                        facts.self_assigns.append(
                            (chain[1], bool(held), node.lineno))
                for child in ast.iter_child_nodes(node):
                    visit(child)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in func.body:
            visit(stmt)
        facts._mod_rel = mod.rel
        return facts

    # -- cross-module graph ---------------------------------------------------

    def finalize(self) -> List[Finding]:
        # fixpoint: lock-acquire closure per callable name bucket
        all_facts: List[_FuncFacts] = []
        for lst in self._class_funcs.values():
            all_facts.extend(lst)
        for lst in self._free_funcs.values():
            all_facts.extend(lst)

        closures: Dict[str, Set[str]] = {f.key: set(f.acquires)
                                         for f in all_facts}

        def callee_keys(facts: _FuncFacts, kind: str,
                        callee: str) -> List[str]:
            out: List[str] = []
            if kind == "self":
                cls = facts.key.split(":")[-1].split(".")[0] \
                    if "." in facts.key.split(":")[-1] else None
                if cls is not None:
                    out += [f.key for f in
                            self._class_funcs.get((cls, callee), [])]
            elif kind == "free":
                out += [f.key for f in self._free_funcs.get(callee, [])]
            elif kind == "method" and callee not in _BUILTIN_METHODS:
                for (c, m), lst in self._class_funcs.items():
                    if m == callee:
                        out += [f.key for f in lst]
            return out

        changed = True
        while changed:
            changed = False
            for facts in all_facts:
                acc = closures[facts.key]
                before = len(acc)
                for _, kind, callee, _ in facts.all_calls:
                    for k in callee_keys(facts, kind, callee):
                        acc |= closures.get(k, set())
                if len(acc) != before:
                    changed = True

        # edges: direct nesting events + lock-held call sites
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for facts in all_facts:
            rel = facts._mod_rel
            for held, acquired, line in facts.events:
                for h in held:
                    if h != acquired:
                        edges.setdefault((h, acquired), (rel, line))
            for held, kind, callee, line in facts.calls:
                for k in callee_keys(facts, kind, callee):
                    for lock in closures.get(k, set()):
                        for h in held:
                            if h != lock:
                                edges.setdefault((h, lock), (rel, line))
        self.lock_edges = edges

        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        findings = list(self._findings)
        seen_cycles: Set[frozenset] = set()
        while True:
            cycle = find_cycle(adj)
            if cycle is None:
                break
            key = frozenset(cycle)
            if key not in seen_cycles:
                seen_cycles.add(key)
                a, b = cycle[0], cycle[1]
                rel, line = edges.get((a, b), ("<unknown>", 0))
                mod = self._mods.get(rel)
                msg = ("lock-order cycle: " + " -> ".join(cycle)
                       + " (witness edge at this line; some other path "
                         "acquires these locks in the reverse order)")
                if mod is not None:
                    findings.append(mod.finding(line, "CONC001", msg,
                                                self.name))
                else:
                    findings.append(Finding(rel, line, "CONC001", msg,
                                            self.name))
            # break ONE edge of the reported cycle and look again, so
            # distinct cycles each get a finding without looping forever
            adj[cycle[0]].discard(cycle[1])
        return findings
