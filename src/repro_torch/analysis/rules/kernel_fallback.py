"""kernel-fallback-shape (AIR006): every kernel package keeps the port's
kernel contract.

Each ``repro_torch/kernels/<name>/`` package exposes its entry points
from ``ops`` (re-exported by ``__init__``) and keeps the kernel's plain
PyTorch version in ``ref``.  The dispatch is ``cuda → numpy``: a tensor
on a CUDA device launches the hand-written kernel or the call raises,
a CPU tensor runs the plain version (the tests), and a ``backend=``
argument names ``"cuda"`` and ``"numpy"``.  The plain version is the
kernel's yardstick, never its fallback: a handler that catches a
kernel's failure and hands the work to ``ref`` would hide a broken
build or launch behind a slower correct answer.  Kernels build at first
use (``repro_torch/kernels/_cuda.py``), so a package that imports
``triton`` or compiles at module level would make importing the port
need a card and a compiler.

Per scanned ``repro_torch/kernels/<name>/`` package this rule checks:

* ``ops.py`` and ``ref.py`` exist,
* ``__init__.py`` imports from ``.ops``,
* ``ops.py`` dispatches on the device (compares a ``.type`` with
  ``"cuda"``) or on a ``backend`` parameter whose module names both
  ``"cuda"`` and ``"numpy"``,
* no ``except`` handler in the package reaches the ``ref`` module or a
  name imported from it,
* no module-level ``import triton``, ``cpp_extension.load`` /
  ``load_inline`` call, ``.build()`` call or call with an ``"nvcc"``
  argument.
"""
from __future__ import annotations

import ast
import os
import re

from ..core import Finding, ProjectRule, dotted_name, norm_path

_PKG_RE = re.compile(r"(?P<root>.*/repro_torch/kernels)/(?P<pkg>[^/]+)/")

_BACKENDS = ("cuda", "numpy")

#: module-level calls that build a kernel (dotted-name suffixes)
_BUILD_CALLS = ("cpp_extension.load", "cpp_extension.load_inline",
                "load_inline")


def _parse(path):
    try:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        return ast.parse(src, filename=path)
    except (SyntaxError, ValueError, OSError):
        return None  # AIR999 covers parse failures


def _has_backend_param(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            names = [p.arg for p in
                     a.posonlyargs + a.args + a.kwonlyargs]
            if "backend" in names:
                return True
    return False


def _string_literals(tree) -> set:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _dispatches_on_device(tree) -> bool:
    """A comparison of some ``<x>.type`` with the literal ``"cuda"``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if any(isinstance(s, ast.Attribute) and s.attr == "type"
               for s in sides) and any(
                isinstance(s, ast.Constant) and s.value == "cuda"
                for s in sides):
            return True
    return False


def _imports_from_ops(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "ops" or mod.endswith(".ops"):
                return True
            if any(a.name == "ops" for a in node.names):
                return True
    return False


def _ref_names(tree) -> set:
    """Names bound to the ``ref`` module or imported from it."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "ref" or mod.endswith(".ref"):
                names.update(a.asname or a.name for a in node.names)
            else:
                names.update(a.asname or a.name for a in node.names
                             if a.name == "ref")
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0]
                         for a in node.names
                         if a.name.split(".")[-1] == "ref")
    return names


def _fallback_handlers(tree):
    """``except`` handlers whose body names a ``ref`` binding."""
    refs = _ref_names(tree)
    if not refs:
        return
    handlers = sorted((n for n in ast.walk(tree)
                       if isinstance(n, ast.ExceptHandler)),
                      key=lambda n: (n.lineno, n.col_offset))
    for node in handlers:
        if any(isinstance(sub, ast.Name) and sub.id in refs
               for sub in ast.walk(node)):
            yield node


def _module_level(tree):
    """Statements that run at import: the module body and the bodies of
    its top-level ``if``/``try``/``with`` blocks (not functions or
    classes)."""
    todo = list(tree.body)
    while todo:
        stmt = todo.pop(0)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            todo.extend(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            todo.extend(h.body)


def _calls(stmt):
    """Calls in a statement's own expressions: not in its nested
    statements (yielded by :func:`_module_level` on their own) and not
    in lambdas, which run later."""
    todo = []
    for _name, value in ast.iter_fields(stmt):
        values = value if isinstance(value, list) else [value]
        todo += [v for v in values if isinstance(v, ast.expr)]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Call):
            yield node
        todo.extend(ast.iter_child_nodes(node))


def _eager_builds(tree):
    """Module-level ``import triton`` and build calls → (node, what)."""
    for stmt in _module_level(tree):
        if isinstance(stmt, ast.Import):
            if any(a.name.split(".")[0] == "triton" for a in stmt.names):
                yield stmt, "imports triton"
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.level == 0 and (stmt.module or "").split(".")[0] \
                    == "triton":
                yield stmt, "imports triton"
        for node in _calls(stmt):
            fn = dotted_name(node.func) or ""
            if fn.endswith(_BUILD_CALLS) or fn.split(".")[-1] == "build":
                yield node, f"calls {fn}()"
            elif any(isinstance(s, ast.Constant) and s.value == "nvcc"
                     for a in node.args for s in ast.walk(a)):
                yield node, "calls nvcc"


class KernelFallbackShapeRule(ProjectRule):
    name = "kernel-fallback-shape"
    code = "AIR006"
    description = ("every repro_torch/kernels/* package ships ops.py + "
                   "ref.py, re-exports from .ops, dispatches cuda → numpy, "
                   "never hands a failed kernel to ref, and builds lazily")

    def _finding(self, path, line, col, message) -> Finding:
        return Finding(rule=self.name, code=self.code, path=path,
                       line=line, col=col, message=message)

    def check_project(self, files):
        pkgs: dict[str, dict[str, str]] = {}
        for p in files:
            m = _PKG_RE.search(norm_path(p))
            if not m:
                continue
            pkgs.setdefault(m.group("pkg"), {})[
                os.path.basename(p)] = p
        for pkg in sorted(pkgs):
            yield from self._check_package(pkg, pkgs[pkg])

    def _check_package(self, pkg, members):
        init = members.get("__init__.py")
        anchor = init or next(iter(sorted(members.values())))
        for required in ("ops.py", "ref.py"):
            if required not in members:
                yield self._finding(
                    anchor, 1, 1,
                    f"kernel package '{pkg}' is missing {required} — every "
                    f"kernel ships a dispatching ops module and its plain "
                    f"PyTorch version")
        if init is not None:
            tree = _parse(init)
            if tree is not None and not _imports_from_ops(tree):
                yield self._finding(
                    init, 1, 1,
                    f"kernel package '{pkg}' __init__.py does not "
                    f"re-export from .ops")
        ops = members.get("ops.py")
        tree = _parse(ops) if ops is not None else None
        if tree is not None:
            literals = _string_literals(tree)
            by_backend = _has_backend_param(tree) and all(
                b in literals for b in _BACKENDS)
            if not (by_backend or _dispatches_on_device(tree)):
                yield self._finding(
                    ops, 1, 1,
                    f"kernel package '{pkg}' ops.py dispatches neither on "
                    f"the tensor's device (a '.type == \"cuda\"' test) nor "
                    f"on a backend= naming 'cuda' and 'numpy'")
        for name in sorted(members):
            path = members[name]
            mod = _parse(path)
            if mod is None:
                continue
            for h in _fallback_handlers(mod):
                yield self._finding(
                    path, h.lineno, h.col_offset + 1,
                    f"kernel package '{pkg}' {name}: an except handler "
                    f"reaches the plain version in ref — a failed kernel "
                    f"must raise, not fall back")
            for node, what in _eager_builds(mod):
                yield self._finding(
                    path, node.lineno, node.col_offset + 1,
                    f"kernel package '{pkg}' {name} {what} at module level "
                    f"— kernels build at first use through "
                    f"repro_torch/kernels/_cuda.py")
