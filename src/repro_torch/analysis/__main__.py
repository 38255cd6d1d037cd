"""airlint CLI of the port — ``python -m repro_torch.analysis [paths...]``.

Human output is one ``path:line:col: CODE [rule] message`` line per
finding (sorted, grep-friendly); ``--json FILE`` additionally writes a
machine-readable report with a stable schema (``version`` bumps on any
breaking change), the same schema as the JAX package's airlint.

Exit codes: 0 clean, 1 findings, 2 usage / unknown rule.
"""
from __future__ import annotations

import argparse
import json
import sys

from .core import run_checks
from .rules import ALL_RULES, rules_by_name

#: bump on any breaking change to the --json report shape
JSON_SCHEMA_VERSION = 1


def build_report(paths, rules, findings, files_scanned) -> dict:
    return {
        "version": JSON_SCHEMA_VERSION,
        "paths": list(paths),
        "rules": [{"name": r.name, "code": r.code,
                   "description": r.description} for r in rules],
        "files_scanned": files_scanned,
        "findings": [f.to_dict() for f in findings],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="airlint: AST-based invariant checks for the port "
                    "(pread seam, lock discipline, typed errors, spec "
                    "round trips, shims, kernel shape).")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to scan "
                             "(default: src/repro_torch)")
    parser.add_argument("--rules", default=None, metavar="NAME[,NAME...]",
                        help="comma-separated rule subset (default: all)")
    parser.add_argument("--json", default=None, metavar="FILE",
                        dest="json_path",
                        help="also write a machine-readable report here")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.code}  {r.name:<22} {r.description}")
        return 0

    try:
        names = ([n.strip() for n in args.rules.split(",") if n.strip()]
                 if args.rules else None)
        rules = rules_by_name(names)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    paths = args.paths or ["src/repro_torch"]
    findings, files_scanned = run_checks(paths, rules)

    if args.json_path:
        report = build_report(paths, rules, findings, files_scanned)
        with open(args.json_path, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    for f in findings:
        print(f.format())
    noun = "finding" if len(findings) == 1 else "findings"
    print(f"airlint: {len(findings)} {noun} in {files_scanned} files "
          f"({len(rules)} rules)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
