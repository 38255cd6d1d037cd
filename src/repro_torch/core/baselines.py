"""Baseline index structures (paper §7.1, Appendix B) as *registered
builder families* competing inside the Alg. 2 search.

The paper's headline claim (§7, Fig. 12) is that AirIndex's search space
*contains* the baselines, so data-and-I/O-aware tuning can only win.
Each baseline is a family in
:data:`repro_torch.core.registry.BUILDER_FAMILIES`, so ``make_builders`` /
``TuneSpec.families`` resolve them by name and every search strategy
(airtune / beam / brute_force) can mix them freely with ``gstep`` /
``gband`` / ``eband`` — the dominance claim becomes a property of the
search itself.  Host-side numpy, bit-identical to the JAX package's
``repro.core.baselines``.

Registered families (λ is the Eq. 8 grid parameter; ``p`` is ignored —
each family's discipline fixes the node shape):

  * ``btree``    — B-TREE page discipline: one node = one λ-byte page,
    fanout fills the page (λ/16 − 1 entries); λ = 4096 reproduces the
    paper's GStep(255, 4096) B-TREE exactly.
  * ``rmi_leaf`` — RMI/CDFShop equal-key-range linear leaf models; λ is
    the target bytes of data per model, so the Eq. 8 grid sweeps the
    model count ``n`` (CDFShop's knob).
  * ``pgm``      — PGM / FITing-tree ε-bounded greedy PLA; λ is the
    error bound ε in bytes (band width 2δ ≤ 2ε).  The paper's ε grid
    {16 … 1024} *records* is :data:`PGM_EPS_GRID` × record size —
    :func:`pgm_builders` instantiates exactly that candidate set.

``btree`` and ``pgm`` also register fused multi-λ entries so they ride
the sweep engine's λ-column fast path; ``rmi_leaf`` instead exposes
``canonical_lam`` (λ → its clamped model count) so the engine's per-λ
fallback builds once per distinct ``n`` and the ``LayerCache`` dedups
the rest (counted in ``TuneStats.layers_reused``).

Free functions over the registered families, with the paper's fixed
shapes:

  * :func:`build_fixed_btree`   — B-TREE: the ``btree`` family at one
    page size, stacked until a single-node root.
  * :func:`tune_rmi`            — RMI/CDFShop-style: two layers, linear
    root partitioning the key space equally over n linear leaf models;
    n swept on a grid (CDFShop recommends a Pareto set; we take the best
    under the storage model — a *stronger* baseline than the paper's).
  * :func:`tune_pgm`            — PGM-style: the ``pgm`` family stacked
    bottom-up with the same ε per layer; ε swept per the paper's grid.
  * :func:`data_calculator`     — exhaustive grid over homogeneous step
    designs (restricted branching functions, cost-model driven).
  * :func:`homogeneous_airtune` — AirTune restricted to one node type
    (the §2.2 Step-only / PWL-only comparison).
"""
from __future__ import annotations

import numpy as np

from .airtune import TuneResult, TuneStats, airtune
from .builders import (LayerBuilder, build_gband, build_gband_multi,
                       build_gstep, check_disjoint, fit_bands_for_groups,
                       greedy_partition, gstep_from_starts, make_builders)
from .keyset import KeyPositions, POS_DTYPE
from .latency import IndexDesign, expected_latency
from .nodes import STEP_PIECE_BYTES, BandLayer, outline
from .registry import (BUILDER_FAMILIES, register_builder,
                       register_multi_lam_builder)
from .storage import StorageProfile

#: the baseline families this module registers, in paper order
BASELINE_FAMILIES = ("btree", "rmi_leaf", "pgm")

BTREE_PAGE_BYTES = 4096.0         # Appendix B: 4 KB pages, 255 fanout
PGM_RECORD_BYTES = 16             # the paper's fixed record size
PGM_EPS_GRID = (16, 32, 64, 128, 256, 512, 1024)   # ε in records (§7.1)


def _stack_until_root(D: KeyPositions, build_one, max_layers: int = 16):
    """Repeatedly build a layer on the previous outline until single-node."""
    layers = []
    cur = D
    for _ in range(max_layers):
        layer = build_one(cur)
        nxt = outline(layer, cur)
        if nxt.size_bytes >= cur.size_bytes:
            break  # no longer shrinking: stop below this layer
        layers.append(layer)
        cur = nxt
        if len(layer.node_sizes()) <= 1:
            break
    return IndexDesign(layers=tuple(layers), data=D)


# ---------------------------------------------------------------------------
# B-TREE family: page discipline — node = one λ-byte page, fanout fills it
# ---------------------------------------------------------------------------
def btree_fanout(page_bytes: float) -> int:
    """Entries of a B-tree node that fills one page: page/16 B − 1 (one
    slot reserved for the fence pointer — 4 KB pages give the paper's
    255 fanout)."""
    return max(int(float(page_bytes)) // STEP_PIECE_BYTES - 1, 1)


@register_builder("btree")
def build_btree_layer(D: KeyPositions, lam: float, p: int):
    """B-TREE node discipline (Appendix B): a greedy step layer whose
    page size is λ and whose fanout fills the page.  ``p`` is ignored —
    the page alone fixes the node shape (that IS the discipline)."""
    return build_gstep(D, p=btree_fanout(lam), lam=float(lam))


@register_multi_lam_builder("btree")
def build_btree_multi(D: KeyPositions, lams, p: int) -> list:
    """Fused λ-column for ``btree``: the greedy boundaries AND the
    per-page fanout both follow λ, so dedup keys on (boundaries, fanout).
    Each element is bit-identical to :func:`build_btree_layer` at that λ."""
    check_disjoint(D)
    lo_f, hi_f = D.lo_f, D.hi_f       # one float64 conversion for all λ
    layers, by_key = [], {}
    for lam in lams:
        fanout = btree_fanout(lam)
        starts = greedy_partition(lo_f, hi_f, float(lam))
        key = (starts.tobytes(), fanout)
        layer = by_key.get(key)
        if layer is None:
            layer = by_key[key] = gstep_from_starts(D, starts, fanout)
        layers.append(layer)
    return layers


def build_fixed_btree(D: KeyPositions, p: int | None = None,
                      lam: float = BTREE_PAGE_BYTES) -> IndexDesign:
    """B-TREE (Appendix B): the registered ``btree`` family stacked until
    a single-node root.  ``p=None`` (default) follows the page discipline
    (fanout = λ/16 − 1, i.e. GStep(255, 4096) at the default page); an
    explicit ``p`` keeps the legacy decoupled (p, λ) node shape."""
    if p is None:
        return _stack_until_root(
            D, lambda c: BUILDER_FAMILIES.get("btree")(c, lam, 0))
    return _stack_until_root(D, lambda c: build_gstep(c, p=p, lam=lam))


# ---------------------------------------------------------------------------
# RMI family: equal-key-range linear leaf models (CDF root routing)
# ---------------------------------------------------------------------------
def rmi_slot_starts(D: KeyPositions, n_models: int):
    """Equal-key-range slot assignment of the linear CDF root.

    Returns ``(n, bounds, gid, starts)``: the clamped model count, the
    model-slot boundary keys, each pair's slot id, and the start indices
    of the present (non-empty) slots.  Build-time grouping and
    lookup-time routing both use ``searchsorted`` over ``bounds``, so
    they agree by construction.
    """
    n_models = max(min(int(n_models), D.n), 1)
    k0 = int(D.keys[0])
    span = max(int(D.keys[-1]) - k0, 1)
    n_models = min(n_models, span + 1)
    bounds = (k0 + np.arange(n_models, dtype=np.float64)
              * (span + 1) / n_models).astype(np.uint64)
    gid = np.searchsorted(bounds, D.keys, side="right") - 1
    gid = np.clip(gid, 0, n_models - 1)
    starts = np.flatnonzero(np.diff(gid, prepend=-1))
    return n_models, bounds, gid, starts


def rmi_models_for_lam(D: KeyPositions, lam: float) -> int:
    """λ → model count: each leaf model covers ~λ bytes of the collection
    (the Eq. 8 granularity semantics), clamped exactly like
    :func:`rmi_slot_starts` so equal results mean equal structures."""
    n = max(int(D.size_bytes // max(float(lam), 1.0)), 1)
    n = max(min(n, D.n), 1)
    if D.n:
        span = max(int(D.keys[-1]) - int(D.keys[0]), 1)
        n = min(n, span + 1)
    return n


def build_rmi_leaf(D: KeyPositions, n_models: int) -> BandLayer:
    """One equal-key-range linear-leaf layer: the RMI bottom level fitted
    over the present slots (one band per non-empty slot)."""
    _, _, _, starts = rmi_slot_starts(D, n_models)
    return fit_bands_for_groups(D, starts)


@register_builder("rmi_leaf")
def _rmi_leaf_family(D: KeyPositions, lam: float, p: int):
    return build_rmi_leaf(D, rmi_models_for_lam(D, lam))


# many λ values clamp to the same model count: the sweep engine's per-λ
# fallback consults canonical_lam so those builders share one LayerCache
# entry (the reuse shows up in TuneStats.layers_reused)
_rmi_leaf_family.canonical_lam = rmi_models_for_lam


def build_rmi(D: KeyPositions, n_models: int) -> IndexDesign:
    """Two-layer RMI with an equal-key-range linear root (CDF root model),
    materialized for on-storage serving: the bottom level stores one 40 B
    record per model *slot* (empty slots get a whole-data fallback band,
    never queried for existing keys) so the root can address slot j at
    byte 40·j exactly."""
    n_models, bounds, gid, starts = rmi_slot_starts(D, n_models)
    leaf = fit_bands_for_groups(D, starts)        # == build_rmi_leaf
    present = gid[starts]

    k0 = int(D.keys[0])
    span = max(int(D.keys[-1]) - k0, 1)
    node_keys = bounds
    x1 = node_keys.copy()
    y1 = np.full(n_models, (D.lo[0] + D.hi[-1]) // 2, dtype=POS_DTYPE)
    m = np.zeros(n_models, dtype=np.float64)
    delta = np.full(n_models, (D.hi[-1] - D.lo[0]) / 2 + 2.0, dtype=np.float64)
    y1[present] = leaf.y1
    m[present] = leaf.m
    delta[present] = leaf.delta
    x1[present] = leaf.x1
    bottom = BandLayer(node_keys=node_keys, x1=x1, y1=y1, m=m, delta=delta,
                       clamp_lo=int(D.lo[0]), clamp_hi=int(D.hi[-1]))

    # root: single band mapping key → 40-byte model slot (exact ±1 slot)
    slot_bytes = 40.0
    root = BandLayer(
        node_keys=np.array([0], dtype=np.uint64),
        x1=np.array([k0], dtype=np.uint64),
        y1=np.array([int(slot_bytes // 2)], dtype=POS_DTYPE),
        m=np.array([slot_bytes * n_models / (span + 1)], dtype=np.float64),
        delta=np.array([slot_bytes + 1.0], dtype=np.float64),
        clamp_lo=0, clamp_hi=int(slot_bytes) * n_models)
    return IndexDesign(layers=(bottom, root), data=D)


def tune_rmi(D: KeyPositions, profile: StorageProfile,
             grid=(2**8, 2**10, 2**12, 2**14, 2**16, 2**18, 2**20)) -> TuneResult:
    best, best_cost = None, np.inf
    for n_models in grid:
        if n_models > D.n:
            break
        design = build_rmi(D, n_models)
        cost = expected_latency(design, profile)
        if cost < best_cost:
            best, best_cost = design, cost
    return TuneResult(design=best, cost=best_cost, stats=TuneStats(),
                      strategy="rmi")


# ---------------------------------------------------------------------------
# PGM family: ε-bounded greedy PLA (FITing-tree / PGM segment discipline)
# ---------------------------------------------------------------------------
@register_builder("pgm")
def build_pgm_layer(D: KeyPositions, lam: float, p: int):
    """ε-bounded greedy PLA: λ is the error bound ε in BYTES — every
    emitted segment keeps its band half-width δ ≤ ε (+fit safety), i.e.
    |ŷ(x) − y(x)| ≤ ε for all indexed keys.  ``p`` is ignored."""
    return build_gband(D, lam=2.0 * float(lam))


@register_multi_lam_builder("pgm")
def build_pgm_multi(D: KeyPositions, lams, p: int) -> list:
    return build_gband_multi(D, [2.0 * float(lam) for lam in lams], p)


def pgm_builders(record_bytes: int = PGM_RECORD_BYTES,
                 grid=PGM_EPS_GRID) -> list[LayerBuilder]:
    """The paper's PGM candidate set: ε ∈ {16 … 1024} records."""
    return [LayerBuilder(kind="pgm", lam=float(eps * record_bytes))
            for eps in grid]


def build_pgm(D: KeyPositions, eps_records: int,
              record_bytes: int = PGM_RECORD_BYTES) -> IndexDesign:
    """PGM (Appendix B): the registered ``pgm`` family stacked bottom-up
    with the same ε per layer."""
    eps_bytes = float(eps_records * record_bytes)
    return _stack_until_root(
        D, lambda c: BUILDER_FAMILIES.get("pgm")(c, eps_bytes, 0))


def tune_pgm(D: KeyPositions, profile: StorageProfile,
             grid=PGM_EPS_GRID) -> TuneResult:
    best, best_cost = None, np.inf
    for eps in grid:
        design = build_pgm(D, eps)
        cost = expected_latency(design, profile)
        if cost < best_cost:
            best, best_cost = design, cost
    return TuneResult(design=best, cost=best_cost, stats=TuneStats(),
                      strategy="pgm")


# ---------------------------------------------------------------------------
# DATA CALCULATOR (Appendix B): exhaustive homogeneous-step grid
# ---------------------------------------------------------------------------
def data_calculator(D: KeyPositions, profile: StorageProfile,
                    lam_grid=None, p_grid=(16, 64, 255, 1024),
                    max_layers: int = 4) -> TuneResult:
    """Cost-model-driven exhaustive search, restricted to step branching and
    one (p, λ) shared across layers — the paper's characterization of Data
    Calculator's auto-completion (grid-search-like, restricted functions)."""
    if lam_grid is None:
        lam_grid = [2.0**s for s in range(10, 22, 2)]
    stats = TuneStats()
    best, best_cost = IndexDesign(layers=(), data=D), expected_latency(
        IndexDesign(layers=(), data=D), profile)
    gstep = BUILDER_FAMILIES.get("gstep")
    for p in p_grid:
        for lam in lam_grid:
            design = _stack_until_root(
                D, lambda c: gstep(c, lam, p), max_layers)
            stats.layers_built += design.n_layers
            for L in range(1, design.n_layers + 1):
                sub = IndexDesign(layers=design.layers[:L], data=D)
                stats.vertices_visited += 1
                cost = expected_latency(sub, profile)
                if cost < best_cost:
                    best, best_cost = sub, cost
    return TuneResult(design=best, cost=best_cost, stats=stats,
                      strategy="datacalc")


# ---------------------------------------------------------------------------
# Homogeneous AirTune (§2.2 Step-only vs PWL-only vs heterogeneous)
# ---------------------------------------------------------------------------
def homogeneous_airtune(D: KeyPositions, profile: StorageProfile, kind: str,
                        **kw) -> TuneResult:
    kinds = {"step": ("gstep",), "band": ("gband", "eband")}[kind]
    builders = make_builders(kinds=kinds)
    return airtune(D, profile, builders, **kw)
