"""airlint framework of the port: findings, rule base classes, allow
parsing, runner — the JAX package's ``repro.analysis.core``, copied so the
port needs nothing of that package.

Pure stdlib (``ast`` + ``re``) on purpose — the linter must run in any
environment the repo does, including a bare CI container before heavier
dependencies import.  Rules come in two shapes:

* :class:`Rule` — per-file AST checks; the runner hands each one the
  parsed tree and source lines of every ``.py`` file under the scanned
  paths.
* :class:`ProjectRule` — whole-tree checks that run once (import-based
  spec introspection, kernel package shape).

Findings carry ``(rule, code, path, line, col, message)`` and are
suppressible with ``# airlint: allow[<rule>] -- <reason>`` on the finding
line or alone on the line directly above.  An allow without a reason is
itself a finding (``AIR000``): a suppression is an argued exception, and
the argument is the point.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re

#: the suppression comment grammar.  The reason (after ``--``) is
#: mandatory for the allow to take effect; matching is per rule name.
ALLOW_RE = re.compile(
    r"#\s*airlint:\s*allow\[(?P<rule>[a-z0-9_-]+)\]"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$")

ALLOW_HYGIENE_RULE = "allow-hygiene"
ALLOW_HYGIENE_CODE = "AIR000"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    code: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} [{self.rule}] {self.message}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base for per-file AST rules.  Subclasses set ``name`` / ``code`` /
    ``description`` and implement :meth:`check_file`."""

    name: str = ""
    code: str = ""
    description: str = ""

    def check_file(self, path: str, tree: ast.AST, lines: list[str]):
        """→ iterable of :class:`Finding` for one parsed source file.
        ``path`` is the runner-relative path reported in findings."""
        raise NotImplementedError

    def finding(self, path: str, node_or_line, message: str,
                col: int | None = None) -> Finding:
        """Build a finding anchored at an AST node (or a 1-based line)."""
        if isinstance(node_or_line, int):
            line, c = node_or_line, col or 1
        else:
            line = getattr(node_or_line, "lineno", 1)
            c = (col if col is not None
                 else getattr(node_or_line, "col_offset", 0) + 1)
        return Finding(rule=self.name, code=self.code, path=path,
                       line=line, col=c, message=message)


class ProjectRule(Rule):
    """Base for whole-tree rules that run once per invocation."""

    def check_project(self, files: list[str]):
        """→ iterable of :class:`Finding`; ``files`` are all collected
        ``.py`` paths (runner-relative)."""
        raise NotImplementedError

    def check_file(self, path, tree, lines):   # pragma: no cover - unused
        return ()


@dataclasses.dataclass(frozen=True)
class Allow:
    """One parsed suppression comment."""

    rule: str
    line: int          # the line the allow suppresses findings on
    comment_line: int  # where the comment physically sits
    reason: str | None


def collect_allows(lines: list[str]) -> list[Allow]:
    """Parse every ``# airlint: allow[...]`` comment in a source file.

    A comment sharing a line with code suppresses findings on that line;
    a comment alone on its line suppresses findings on the next
    non-comment line (so a justification may continue across further
    comment lines between the allow and the code it covers).
    """
    allows = []
    for i, raw in enumerate(lines, start=1):
        m = ALLOW_RE.search(raw)
        if not m:
            continue
        code_before = raw[:m.start()].strip()
        if code_before:
            target = i
        else:
            target = i + 1
            while target <= len(lines) and (
                    not lines[target - 1].strip()
                    or lines[target - 1].lstrip().startswith("#")):
                target += 1
        allows.append(Allow(rule=m.group("rule"), line=target,
                            comment_line=i, reason=m.group("reason")))
    return allows


def apply_allows(findings: list[Finding],
                 allows_by_path: dict[str, list[Allow]]) -> list[Finding]:
    """Drop findings covered by a justified allow; emit an ``AIR000``
    finding for every allow that lacks a reason (those never suppress)."""
    out = []
    for f in findings:
        allows = allows_by_path.get(f.path, ())
        if any(a.rule == f.rule and a.line == f.line and a.reason
               for a in allows):
            continue
        out.append(f)
    for path, allows in allows_by_path.items():
        for a in allows:
            if not a.reason:
                out.append(Finding(
                    rule=ALLOW_HYGIENE_RULE, code=ALLOW_HYGIENE_CODE,
                    path=path, line=a.comment_line, col=1,
                    message=f"allow[{a.rule}] without a justification — "
                            f"write '# airlint: allow[{a.rule}] -- <reason>'"))
    return out


def collect_py_files(paths: list[str]) -> list[str]:
    """All ``.py`` files under the given files/directories, sorted,
    ``__pycache__`` pruned.  Paths are returned as given (relative stays
    relative) so findings print runner-relative locations."""
    files = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                files.append(p)
            continue
        for root, dirnames, names in os.walk(p):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            files.extend(os.path.join(root, n)
                         for n in names if n.endswith(".py"))
    return sorted(set(files))


def run_checks(paths: list[str], rules: list[Rule]) -> tuple[list, int]:
    """Run ``rules`` over every ``.py`` file under ``paths``.

    → ``(findings, files_scanned)``; findings are allow-filtered and
    sorted ``(path, line, code)``.  A file that fails to parse yields a
    finding (code ``AIR999``) rather than an exception — a syntax error
    must fail the gate, not crash it.
    """
    files = collect_py_files(paths)
    findings: list[Finding] = []
    allows_by_path: dict[str, list[Allow]] = {}
    file_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]
    for path in files:
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (SyntaxError, ValueError, OSError) as e:
            findings.append(Finding(
                rule="parse", code="AIR999", path=path,
                line=getattr(e, "lineno", 1) or 1, col=1,
                message=f"could not parse: {e}"))
            continue
        lines = src.splitlines()
        allows_by_path[path] = collect_allows(lines)
        for rule in file_rules:
            findings.extend(rule.check_file(path, tree, lines))
    for rule in project_rules:
        findings.extend(rule.check_project(files))
    findings = apply_allows(findings, allows_by_path)
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.col))
    return findings, len(files)


# -- shared AST helpers ------------------------------------------------------
def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def norm_path(path: str) -> str:
    """Forward-slash form for suffix matching regardless of platform."""
    return path.replace(os.sep, "/")
