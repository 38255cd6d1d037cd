"""Built index designs (paper §4.3).

A *design* is the bottom-up list of built layers ``[Θ_1, …, Θ_L]`` (layer 1
sits directly on the data layer) together with the collection it indexes.
"""
from __future__ import annotations

import dataclasses

from .keyset import KeyPositions
from .nodes import mean_width, outline


@dataclasses.dataclass(frozen=True)
class IndexDesign:
    """Built hierarchical index: layers bottom-up + the collection indexed."""

    layers: tuple          # (Θ_1, …, Θ_L); () = no index
    data: KeyPositions     # the data layer's key-position collection

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def outlines(self) -> list[KeyPositions]:
        """[D_0=data, D_1=outline(Θ_1), …, D_L]."""
        outs = [self.data]
        for layer in self.layers:
            outs.append(outline(layer, outs[-1]))
        return outs

    def describe(self) -> str:
        outs = self.outlines()
        parts = []
        for i, layer in enumerate(self.layers):
            parts.append(
                f"L{i + 1}:{layer.kind}[nodes={len(layer.node_sizes())}"
                f" size={layer.size_bytes}B"
                f" EΔ={mean_width(layer, outs[i]):.0f}B]")
        return " <- ".join(parts) if parts else "(no index)"
