"""lock-discipline (AIR002): stats/cache under the lock, preads outside it.

The port's pipelined engine (as the JAX package's) shares one lock (``self._mu``) between the
serving thread and the prefetch worker: every ``ServeStats`` mutation and
every block-cache access happens under it, while the preads themselves
(and their retry sleeps) run *outside* it so stage-1 I/O really overlaps
stage-2 compute.  Both directions rot silently — an unlocked ``st.stats.x
+= 1`` is a data race that only shows up as drifting counters under load,
and a pread under the lock serializes the pipeline without failing any
test.  This rule checks both, in any module that uses the ``with
self._mu:`` idiom:

* mutations of ``<x>.stats.<field>`` (assign / augmented assign), calls
  to ``<x>.stats.record_*``, and block-cache accessor calls
  (``<x>.cache.get/put/peek/pop``) must sit under a ``with <x>._mu:``
  block;
* ``.pread`` / ``.pread_full`` calls must NOT sit under one.

Open-time mutations of a not-yet-published epoch are the legitimate
exception — those sites carry a justified allow.
"""
from __future__ import annotations

import ast

from ..core import Rule

#: cache methods that mutate or probe the shared TieredBlockCache
_CACHE_METHODS = {"get", "put", "peek", "pop"}


def _is_mu(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "_mu"


def _stats_member(node: ast.AST):
    """``<x>.stats.<field>`` → field name, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Attribute) \
            and node.value.attr == "stats":
        return node.attr
    return None


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    code = "AIR002"
    description = ("in modules using the self._mu idiom: ServeStats/cache "
                   "mutations only under the lock; backend preads never "
                   "under it")

    def check_file(self, path, tree, lines):
        # gate: only modules that actually use the lock idiom are in scope
        if not any("._mu" in ln for ln in lines):
            return ()
        findings: list = []
        self._walk_body(path, tree.body, locked=False, findings=findings)
        return findings

    # -- recursive statement walk with lock state ---------------------------
    def _walk_body(self, path, stmts, locked: bool, findings: list):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested scope runs later; lock state does not carry over
                self._walk_body(path, stmt.body, locked=False,
                                findings=findings)
                continue
            if isinstance(stmt, ast.With):
                inner = locked or any(_is_mu(item.context_expr)
                                      for item in stmt.items)
                for item in stmt.items:
                    self._check_expr(path, item.context_expr, locked,
                                     findings)
                self._walk_body(path, stmt.body, inner, findings)
                continue
            self._check_stmt(path, stmt, locked, findings)
            # child blocks (if/for/try/class bodies, except handlers) keep
            # the lock state; bare expressions are scanned for calls
            for _name, value in ast.iter_fields(stmt):
                if isinstance(value, ast.AST) \
                        and not isinstance(value, ast.stmt):
                    self._check_expr(path, value, locked, findings)
                elif isinstance(value, list):
                    block = [v for v in value if isinstance(v, ast.stmt)]
                    if block:
                        self._walk_body(path, block, locked, findings)
                    for v in value:
                        if isinstance(v, ast.excepthandler):
                            if v.type is not None:
                                self._check_expr(path, v.type, locked,
                                                 findings)
                            self._walk_body(path, v.body, locked, findings)
                        elif isinstance(v, ast.AST) \
                                and not isinstance(v, ast.stmt):
                            self._check_expr(path, v, locked, findings)

    def _check_stmt(self, path, stmt, locked: bool, findings: list):
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for t in targets:
            field = _stats_member(t)
            if field is not None and not locked:
                findings.append(self.finding(
                    path, t,
                    f"ServeStats mutation '.stats.{field}' outside "
                    f"'with self._mu:' — racing the prefetch worker"))

    def _check_expr(self, path, expr, locked: bool, findings: list):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            owner = node.func.value
            if not locked:
                if _stats_member(node.func) and meth.startswith("record_"):
                    findings.append(self.finding(
                        path, node,
                        f"ServeStats mutation '.stats.{meth}(...)' outside "
                        f"'with self._mu:' — racing the prefetch worker"))
                elif isinstance(owner, ast.Attribute) \
                        and owner.attr == "cache" \
                        and meth in _CACHE_METHODS:
                    findings.append(self.finding(
                        path, node,
                        f"block-cache access '.cache.{meth}(...)' outside "
                        f"'with self._mu:' — the tiered LRU is not "
                        f"thread-safe"))
            else:
                if meth in ("pread", "pread_full"):
                    findings.append(self.finding(
                        path, node,
                        f"'.{meth}(...)' under 'with self._mu:' — I/O must "
                        f"run outside the lock so the pipeline overlaps"))
