"""shim-discipline (AIR005): internal code never uses its own shims.

``repro_torch.core.deprecation`` draws a hard line: the deprecated entry
points carried over from the JAX package warn outside callers and
*assert* when called from inside ``repro_torch``.  That assertion fires
only on the path somebody happens to run; this rule catches the
regression at lint time instead.  Flags:

* calls to the deprecated entry points (``load_index``,
  ``lookup_file``) anywhere in scanned code,
* ``from ... import`` of those names outside ``__init__.py`` re-export
  modules (mirrors the ruff F401 ``__init__.py`` carve-out),
* ``IndexService(...)`` / ``Index.open(...)``-style constructions
  passing a legacy keyword that ``ServeSpec`` replaced
  (``cache_bytes=``, ``use_device=``, ...) — internal code must build a
  ``ServeSpec`` and pass ``spec=``.

Definition sites are untouched (the shims keep existing for outside
callers); only *references* are findings.
"""
from __future__ import annotations

import ast
import os

from ..core import Rule

#: deprecated entry point → its replacement (used in messages)
DEPRECATED_ENTRY_POINTS = {
    "load_index": "repro_torch.api.Index.open(path, data=data).design",
    "lookup_file": "repro_torch.api.Index.open(path).lookup(queries)",
}

#: IndexService kwargs the JAX package folds into ServeSpec; callers pass
#: spec=ServeSpec(...) instead
LEGACY_KWARGS = ("cache_bytes", "cache_profile", "page_bytes",
                 "resident_layers", "use_device", "interpret",
                 "coalesce_gap", "persist_stats")

#: callables whose keyword lists the legacy-kwarg check applies to
_SERVICE_NAMES = {"IndexService"}


class ShimDisciplineRule(Rule):
    name = "shim-discipline"
    code = "AIR005"
    description = ("no internal calls/imports of deprecated entry points "
                   "(load_index, lookup_file) and no legacy IndexService "
                   "kwargs outside __init__.py re-exports")

    def check_file(self, path, tree, lines):
        is_init = os.path.basename(path) == "__init__.py"
        deprecated = set(DEPRECATED_ENTRY_POINTS)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and not is_init:
                for alias in node.names:
                    if alias.name in deprecated:
                        yield self.finding(
                            path, node,
                            f"import of deprecated entry point "
                            f"'{alias.name}' — use "
                            f"{DEPRECATED_ENTRY_POINTS[alias.name]}")
            elif isinstance(node, ast.Call):
                name = (node.func.id if isinstance(node.func, ast.Name)
                        else node.func.attr
                        if isinstance(node.func, ast.Attribute) else None)
                if name in deprecated:
                    yield self.finding(
                        path, node,
                        f"call to deprecated entry point '{name}' — use "
                        f"{DEPRECATED_ENTRY_POINTS[name]} (the shim hard-"
                        f"asserts when called from inside repro_torch)")
                elif name in _SERVICE_NAMES:
                    legacy = [kw.arg for kw in node.keywords
                              if kw.arg in LEGACY_KWARGS]
                    if legacy:
                        yield self.finding(
                            path, node,
                            f"IndexService(...) with legacy kwarg(s) "
                            f"{', '.join(sorted(legacy))} — internal code "
                            f"builds a ServeSpec and passes spec=")
