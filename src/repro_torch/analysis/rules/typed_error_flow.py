"""typed-error-flow (AIR003): broad excepts must not absorb StorageErrors.

The fault-tolerance contract threads typed errors —
``StorageError`` → ``ReadError`` / ``CorruptPageError`` /
``DeadlineExceededError``, plus the fleet's ``ShardUnavailableError`` —
from the pread seam up to availability reports, where operators key on
the concrete class name.  A ``except Exception:`` in ``serve/`` or
``fleet/`` sitting on that path flattens the whole ladder into silence:
the shard shows "degraded(?)" instead of "CorruptPageError", and the
chaos-gate assertions stop meaning anything.

A broad handler (bare ``except:``, ``except Exception``, ``except
BaseException``) in those packages passes only if it provably cannot
absorb a typed storage error:

* its body re-raises (any ``raise`` statement), or
* a *preceding* except clause in the same ``try`` already catches one of
  the typed storage errors (so they never reach the broad one), or
* it carries a justified ``# airlint: allow[typed-error-flow] -- <reason>``
  (e.g. a ``__del__`` / best-effort-shutdown path).
"""
from __future__ import annotations

import ast

from ..core import Rule, norm_path

#: path fragments that put a module on the typed-error path
SCOPED_DIRS = ("/serve/", "/fleet/")

#: the typed ladder; a preceding handler for any of these shields the
#: broad handler from absorbing storage errors
TYPED_ERRORS = {"StorageError", "ReadError", "CorruptPageError",
                "DeadlineExceededError", "ShardUnavailableError"}

_BROAD = {"Exception", "BaseException"}


def _exc_names(type_node: ast.AST | None):
    """Exception class names named by an ``except`` clause (handles
    tuples and dotted references)."""
    if type_node is None:
        return set()
    nodes = (type_node.elts if isinstance(type_node, ast.Tuple)
             else [type_node])
    names = set()
    for n in nodes:
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


class TypedErrorFlowRule(Rule):
    name = "typed-error-flow"
    code = "AIR003"
    description = ("no bare/broad except in serve/ or fleet/ that can "
                   "absorb a typed StorageError without re-raising or a "
                   "preceding typed handler")

    def check_file(self, path, tree, lines):
        p = norm_path(path)
        if not any(d in p for d in SCOPED_DIRS):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            shielded = False  # a preceding typed handler catches the ladder
            for handler in node.handlers:
                names = _exc_names(handler.type)
                if handler.type is None or names & _BROAD:
                    if shielded or _reraises(handler):
                        continue
                    what = ("bare 'except:'" if handler.type is None
                            else f"'except {'/'.join(sorted(names & _BROAD))}'")
                    yield self.finding(
                        path, handler,
                        f"{what} can absorb a typed StorageError — re-raise, "
                        f"add a preceding 'except StorageError' handler, or "
                        f"justify with # airlint: allow[typed-error-flow] "
                        f"-- <reason>")
                elif names & TYPED_ERRORS:
                    shielded = True
