"""airlint for the port — AST-based invariant checks of ``src/repro_torch``.

The JAX package's airlint (``repro.analysis``) checks the JAX package's
contracts; this is the port's own copy, with the same layout, rule names,
codes, CLI (``python -m repro_torch.analysis``, default path
``src/repro_torch``), JSON report and exit codes, and the port's
contracts where they differ: its pread seam is ``repro_torch/serve/
backend.py``, its frozen specs are ``repro_torch``'s, and its kernel
packages dispatch ``cuda → numpy`` with no fallback.

Rules (error codes are stable — tests and suppressions key on them):

====================  =======  ==================================================
rule                  code     contract
====================  =======  ==================================================
pread-seam            AIR001   ``os.pread`` / ``os.open(..., O_RDONLY)`` only in
                               ``repro_torch/serve/backend.py``; everything else
                               goes through a ``StorageBackend`` or carries a
                               justified allow
lock-discipline       AIR002   stats/cache mutations under ``self._mu``; preads
                               never under it (lock-using modules only)
typed-error-flow      AIR003   no broad ``except`` in ``serve/``/``fleet/`` that
                               can absorb a ``StorageError`` without re-raising,
                               a preceding typed handler, or an allow
spec-roundtrip        AIR004   every declared field of the port's frozen spec
                               dataclasses appears in ``to_dict`` and is restored
                               by ``from_json`` / ``from_dict``
shim-discipline       AIR005   no reference to the JAX package's deprecated entry
                               points or legacy ``IndexService`` keywords
kernel-fallback-shape AIR006   every ``kernels/*/`` package ships ``ops`` +
                               ``ref``; ``ops`` dispatches ``cuda → numpy``; no
                               handler falls back to ``ref``; no module-level
                               ``triton`` import or kernel build
allow-hygiene         AIR000   an ``# airlint: allow[rule]`` without a
                               ``-- reason`` justification is itself a finding
====================  =======  ==================================================

Suppression: ``# airlint: allow[<rule>] -- <reason>`` on the offending
line, or alone on a comment line above it (the justification may continue
over following comment lines).  The reason is mandatory.
"""
from .core import Finding, ProjectRule, Rule, collect_allows, run_checks
from .rules import ALL_RULES, rules_by_name

__all__ = ["Finding", "Rule", "ProjectRule", "ALL_RULES", "rules_by_name",
           "collect_allows", "run_checks"]
