"""pread-seam (AIR001): all serving-path reads flow through StorageBackend.

The port's fault seam — retries, exponential backoff, CRC32 verification,
deterministic fault injection — lives in
:class:`repro_torch.serve.StorageBackend`, and every byte the serving
stack reads is supposed to flow through it.  A raw ``os.pread`` (or an
``os.open(..., os.O_RDONLY)`` that exists to feed one) silently opts out
of all of that: no retry budget, no checksum, invisible to the chaos
tests.  This rule flags every such call outside the port's
``serve/backend.py`` (the one module allowed to touch the syscall).
Call sites that *measure* the raw syscall on purpose, or read through a
descriptor their caller owns, carry a justified
``# airlint: allow[pread-seam] -- <reason>``.
"""
from __future__ import annotations

import ast

from ..core import Rule, dotted_name, norm_path

#: the one module allowed to call os.pread / os.open-for-read directly
SEAM_MODULE = "repro_torch/serve/backend.py"


def _mentions_o_rdonly(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "O_RDONLY":
            return True
        if isinstance(sub, ast.Name) and sub.id == "O_RDONLY":
            return True
    return False


class PreadSeamRule(Rule):
    name = "pread-seam"
    code = "AIR001"
    description = ("os.pread / os.open(..., O_RDONLY) only inside "
                   "serve/backend.py; all other call sites must use a "
                   "StorageBackend or carry a justified allow")

    def check_file(self, path, tree, lines):
        if norm_path(path).endswith(SEAM_MODULE):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted_name(node.func)
            if fn == "os.pread":
                yield self.finding(
                    path, node,
                    "raw os.pread bypasses the StorageBackend seam "
                    "(retries / CRC / fault injection); read through "
                    "repro_torch.serve.FileBackend or justify with "
                    "# airlint: allow[pread-seam] -- <reason>")
            elif fn == "os.open" and any(_mentions_o_rdonly(a)
                                         for a in node.args):
                yield self.finding(
                    path, node,
                    "os.open(..., O_RDONLY) opens a read path outside the "
                    "StorageBackend seam; use repro_torch.serve.FileBackend "
                    "(or justify with # airlint: allow[pread-seam] -- "
                    "<reason>)")
