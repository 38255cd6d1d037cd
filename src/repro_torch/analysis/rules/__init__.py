"""airlint rule registry of the port — one module per enforced contract."""
from .kernel_fallback import KernelFallbackShapeRule
from .lock_discipline import LockDisciplineRule
from .pread_seam import PreadSeamRule
from .shim_discipline import ShimDisciplineRule
from .spec_roundtrip import SpecRoundtripRule
from .typed_error_flow import TypedErrorFlowRule

#: every shipped rule, instantiated (rules are stateless between runs)
ALL_RULES = [
    PreadSeamRule(),
    LockDisciplineRule(),
    TypedErrorFlowRule(),
    SpecRoundtripRule(),
    ShimDisciplineRule(),
    KernelFallbackShapeRule(),
]


def rules_by_name(names=None) -> list:
    """Resolve a rule-name subset (None = all).  KeyError lists what
    exists — same contract as the builder/strategy registries."""
    if names is None:
        return list(ALL_RULES)
    by_name = {r.name: r for r in ALL_RULES}
    out = []
    for n in names:
        if n not in by_name:
            raise KeyError(f"unknown rule {n!r}; "
                           f"available: {', '.join(sorted(by_name))}")
        out.append(by_name[n])
    return out


__all__ = ["ALL_RULES", "rules_by_name", "PreadSeamRule",
           "LockDisciplineRule", "TypedErrorFlowRule", "SpecRoundtripRule",
           "ShimDisciplineRule", "KernelFallbackShapeRule"]
