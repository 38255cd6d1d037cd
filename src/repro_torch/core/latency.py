"""End-to-end lookup latency under a storage model (paper §4.3).

``L_SM(x; Θ, T) = T(s(Θ_L)) + Σ_{l=1..L} T(Δ(x; Θ_l))``        (Eq. 5)
``L_SM(X; Θ, T) = E_{x∼X}[ · ]``                                 (Eq. 6)

A *design* here is the bottom-up list of built layers ``[Θ_1, …, Θ_L]``
(layer 1 sits directly on the data layer).  The data-layer read
``T(Δ(x; Θ_1))`` uses layer 1's prediction width; the root layer is read in
full, ``T(s(Θ_L))``; an empty design reads the whole collection, ``T(s_D)``.
Host-side numpy, bit-identical to the JAX package's ``repro.core.latency``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .keyset import KeyPositions
from .nodes import mean_width, outline
from .storage import StorageProfile, normalize_objective, objective_profile


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


def expected_latency(design: IndexDesign, profile: StorageProfile) -> float:
    """Eq. (6) with X uniform over the data layer's (weighted) keys.

    Every layer's prediction width is evaluated at the *original* query
    keys; each original key's lookup path touches exactly one node per
    layer, so ``E_x[T(Δ(x; Θ_l))]`` is a weighted mean over data keys.
    """
    data = design.data
    if design.n_layers == 0:
        return float(profile(data.size_bytes))
    outs = design.outlines()
    total = float(profile(outs[-1].size_bytes))          # root read: T(s(Θ_L))
    for layer in design.layers:                           # Σ_l E[T(Δ(x; Θ_l))]
        wq = layer.widths_at(data.keys)
        total += float(np.average(profile(wq), weights=data.weights))
    return total


def batched_mean_read_costs(widths, weights, profile: StorageProfile) -> np.ndarray:
    """Batched ``E_x[T(Δ)]`` for C candidates at once → (C,) float64.

    ``widths`` is a (C, S) matrix of per-query prediction widths (one row
    per candidate layer, all evaluated at the SAME S query keys);
    ``weights`` the (S,) query weights.  Row c is bit-identical to the
    scalar path ``float(np.average(profile(widths[c]), weights=weights))``:
    the profile applies elementwise and numpy's pairwise reduction over a
    contiguous last axis matches the 1-D reduction exactly.  Profiles that
    are not elementwise-vectorized over 2-D input fall back to a per-row
    loop with the same semantics.
    """
    W = np.asarray(widths, dtype=np.float64)
    if W.ndim == 1:
        W = W[None, :]
    T = np.asarray(profile(W), dtype=np.float64)
    if T.shape != W.shape:          # profile not 2-D-vectorized: row loop
        return np.asarray(
            [float(np.average(np.asarray(profile(w), dtype=np.float64),
                              weights=weights)) for w in W])
    return np.average(T, axis=1, weights=np.asarray(weights,
                                                    dtype=np.float64))


def latency_breakdown(design: IndexDesign, profile: StorageProfile) -> dict:
    """Per-read costs: root + every layer's expected partial read (Eq. 5)."""
    data = design.data
    if design.n_layers == 0:
        t = float(profile(data.size_bytes))
        return {"root": t, "layers": [], "total": t}
    outs = design.outlines()
    root = float(profile(outs[-1].size_bytes))
    per_layer = []
    for layer in design.layers:
        wq = layer.widths_at(data.keys)
        per_layer.append(float(np.average(profile(wq), weights=data.weights)))
    # reads happen top-down: root, then partial reads of layers L−1 … 1, data
    return {"root": root, "layers": per_layer[::-1], "total": root + sum(per_layer)}


def mean_read_volume(design: IndexDesign) -> float:
    """Total expected bytes fetched per query: s(Θ_L) + Σ E[Δ_l] (Fig. 13b)."""
    data = design.data
    if design.n_layers == 0:
        return float(data.size_bytes)
    outs = design.outlines()
    vol = float(outs[-1].size_bytes)
    for layer in design.layers:
        wq = layer.widths_at(data.keys)
        vol += float(np.average(wq, weights=data.weights))
    return vol


def ideal_latency_with_index(profile: StorageProfile) -> float:
    """Cost if an *ideal* extra layer existed: 1-byte root + 1-byte precise
    read of the current level (paper §5.1 stopping criterion)."""
    return float(profile(1.0) + profile(1.0))


def mean_excess_per_lookup(design: IndexDesign, profile: StorageProfile) -> float:
    """Summed per-read upper-tail mass ``Σ E[(Tᵢ − μᵢ)₊]`` over a lookup.

    Mirrors :func:`expected_latency`'s read structure (root in full, one
    partial read per layer, or the whole collection with no index) with
    ``profile.mean_excess`` in place of the mean curve.  Zero for
    deterministic profiles.
    """
    data = design.data
    if design.n_layers == 0:
        return float(profile.mean_excess(data.size_bytes))
    outs = design.outlines()
    total = float(profile.mean_excess(outs[-1].size_bytes))
    for layer in design.layers:
        wq = layer.widths_at(data.keys)
        total += float(np.average(profile.mean_excess(wq),
                                  weights=data.weights))
    return total


def quantile_latency(design: IndexDesign, profile: StorageProfile,
                     p: float) -> float:
    """Estimated per-lookup ``p``-quantile ``Q̂_p[T]`` under ``profile``.

    Independent-pread approximation, documented in
    :class:`~repro_torch.core.storage.ObjectiveProfile`: Markov's inequality on
    the summed positive excess bounds the quantile of a sum of pread
    times by ``Σ μᵢ + (Σ E[(Tᵢ − μᵢ)₊]) / (1 − p)`` — the single-big-jump
    estimate for the stall-dominated tails observed reservoirs exhibit.
    For deterministic profiles this collapses to the mean (Eq. 6).
    """
    if not 0.0 < float(p) < 1.0:
        raise ValueError(f"quantile p must be in (0, 1), got {p}")
    return (expected_latency(design, profile)
            + mean_excess_per_lookup(design, profile) / (1.0 - float(p)))


def objective_latency(design: IndexDesign, profile: StorageProfile,
                      objective) -> float:
    """The tuning objective's value for a built design.

    ``"mean"`` (or None) is Eq. 6 exactly; a ``{"p": q, "weight": w}``
    objective is ``E[T] + w·Q̂_p[T]`` with the quantile from
    :func:`quantile_latency`.  Equal to
    ``expected_latency(design, objective_profile(profile, objective))`` —
    the identity the strategies rely on to rank by the objective through
    the unchanged mean-latency search.
    """
    norm = normalize_objective(objective)
    if norm is None:
        return expected_latency(design, profile)
    return expected_latency(design, objective_profile(profile, objective))
