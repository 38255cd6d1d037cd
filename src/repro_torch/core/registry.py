"""Pluggable registries: builder families ``F`` and search strategies.

The paper frames AirTune as a search over an *open-ended* family of layer
builders (§1).  These registries make that family a runtime-extensible
set, as in the JAX package's ``repro.core.registry``:

  * :data:`BUILDER_FAMILIES` maps a family name (``"gstep"``, ``"gband"``,
    ``"eband"``, …) to a build function ``f(D, lam, p) -> Layer``.
    :class:`repro_torch.core.builders.LayerBuilder` resolves its ``kind``
    through this registry on every call, so a family registered by
    third-party code participates in the Alg. 2 search::

        from repro_torch.core import register_builder

        @register_builder("myfamily")
        def build_my_layer(D, lam, p):
            return ...  # a StepLayer or BandLayer

  * :data:`SEARCH_STRATEGIES` maps a strategy name (``"airtune"``,
    ``"brute_force"``, ``"beam"``, …) to a callable implementing the
    :class:`repro_torch.core.airtune.SearchStrategy` protocol.

The built-in entries are registered when :mod:`repro_torch.core.builders`,
:mod:`repro_torch.core.airtune` and :mod:`repro_torch.core.baselines`
(``"btree"``, ``"rmi_leaf"``, ``"pgm"``) are imported; ``import
repro_torch.core`` imports all three.
"""
from __future__ import annotations


class Registry:
    """Name → object mapping with decorator registration and clear errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, object] = {}

    def register(self, name: str, obj=None):
        """``register(name, obj)`` or ``@register(name)`` decorator form."""
        if obj is None:
            def deco(fn):
                self.register(name, fn)
                return fn
            return deco
        if name in self._entries and self._entries[name] is not obj:
            raise ValueError(
                f"{self.kind} {name!r} is already registered; "
                f"unregister it first to replace it")
        self._entries[name] = obj
        return obj

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(sorted(self._entries)) or '(none)'}") from None

    def names(self) -> tuple:
        return tuple(sorted(self._entries))

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __iter__(self):
        return iter(sorted(self._entries))


#: family name -> build function ``f(D: KeyPositions, lam: float, p: int) -> Layer``
BUILDER_FAMILIES = Registry("builder family")

#: family name -> fused multi-λ build ``f(D, lams, p) -> list[Layer]``.
#: Optional fast path for the sweep engine (repro_torch.core.sweep): one call
#: builds the family's whole Eq. (8) λ-column for a vertex, sharing
#: per-collection precomputation and deduplicating λ values that produce
#: identical partitions.  Families registered only in BUILDER_FAMILIES
#: still work — the sweep engine falls back to per-λ single builds.
MULTI_LAM_FAMILIES = Registry("multi-λ builder family")

#: strategy name -> ``SearchStrategy`` callable (see repro_torch.core.airtune)
SEARCH_STRATEGIES = Registry("search strategy")


def register_builder(name: str, fn=None):
    """Register a layer-builder family ``f(D, lam, p) -> Layer``.

    Optional attribute: ``fn.canonical_lam(D, lam) -> hashable`` maps λ to
    the family's internal parameter (e.g. ``rmi_leaf``'s clamped model
    count).  The sweep engine keys its ``LayerCache`` on the canonical
    value, so grid λs that resolve to the same structure build once and
    count as ``TuneStats.layers_reused``.
    """
    return BUILDER_FAMILIES.register(name, fn)


def register_multi_lam_builder(name: str, fn=None):
    """Register a family's fused multi-λ entry ``f(D, lams, p) -> list[Layer]``.

    The returned list must align with ``lams`` and each element must be
    bit-identical (same arrays) to the single-λ build at that λ; entries
    for λ values yielding the same partition may share one layer object —
    the sweep engine counts those as ``layers_reused``.
    """
    return MULTI_LAM_FAMILIES.register(name, fn)


def register_strategy(name: str, fn=None):
    """Register a search strategy (``SearchStrategy`` protocol)."""
    return SEARCH_STRATEGIES.register(name, fn)
