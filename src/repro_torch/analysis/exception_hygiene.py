"""Exception hygiene checker: no silently swallowed broad handlers.

A broad ``except Exception`` on a serving path is sometimes right — a
failed compaction or a failed background flush must not take down serving.
But "swallow and move on" has a minimum bar, or the failure is invisible
until a user asks why throughput halved:

* the handler must **re-raise** (possibly wrapped), OR
* it must **bind the exception and use it** (preserve context — into a
  ``last_*_error`` attribute, a log record, a telemetry payload) AND
  **account for it** (bump an error counter, record a span, or update an
  error/failure-named field).

**EXC001** flags ``except:``, ``except Exception:`` and
``except BaseException:`` handlers (including tuples containing them) that
miss the bar.  Typed handlers (``except (TableError, OSError)``) are the
caller's business and are not flagged.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .engine import Checker, Finding, Module, attr_chain, call_name

_BROAD = {"Exception", "BaseException"}
_ACCOUNT_CALL_ATTRS = {"inc", "observe", "instant", "span", "record"}
_ACCOUNT_NAME_TOKENS = ("error", "errors", "fail", "failure", "fallback",
                        "warn")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        chain = attr_chain(node)
        if chain is not None and chain[-1] in _BROAD:
            return True
    return False


def _has_name_token(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _ACCOUNT_NAME_TOKENS)


class ExceptionHygieneChecker(Checker):
    name = "exception_hygiene"
    codes = {
        "EXC001": "broad except handler that neither re-raises nor "
                  "preserves+accounts the error (silent swallow)",
    }

    def check_module(self, mod: Module) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and _is_broad(node):
                problem = self._handler_problem(node)
                if problem is not None:
                    findings.append(mod.finding(
                        node.lineno, "EXC001",
                        f"broad except handler {problem} — re-raise, or "
                        f"bind the exception, preserve its context, and "
                        f"bump an error counter / span", self.name))
        return findings

    def _handler_problem(self, handler: ast.ExceptHandler) -> Optional[str]:
        reraises = False
        uses_exc = False
        accounts = False
        bound = handler.name
        for node in ast.walk(ast.Module(body=handler.body,
                                        type_ignores=[])):
            if isinstance(node, ast.Raise):
                reraises = True
            if bound is not None and isinstance(node, ast.Name) and \
                    node.id == bound and isinstance(node.ctx, ast.Load):
                uses_exc = True
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _ACCOUNT_CALL_ATTRS:
                    accounts = True
                cname = call_name(node)
                if cname is not None and _has_name_token(cname):
                    accounts = True
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    tname = None
                    if isinstance(tgt, ast.Name):
                        tname = tgt.id
                    elif isinstance(tgt, ast.Attribute):
                        tname = tgt.attr
                    elif isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.slice, ast.Constant) and \
                            isinstance(tgt.slice.value, str):
                        tname = tgt.slice.value
                    if tname is not None and _has_name_token(tname):
                        accounts = True
        if reraises:
            return None
        if bound is None:
            return "swallows without binding the exception"
        if not uses_exc:
            return f"binds `{bound}` but never uses it (context lost)"
        if not accounts:
            return "preserves context but never accounts the error " \
                   "(no counter/span/error field)"
        return None
