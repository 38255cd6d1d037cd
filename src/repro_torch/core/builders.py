"""Layer builders ``F(D) → Θ`` (paper §5.2, §A.1) and the Eq. (8) grid.

  * ``GStep(p, λ)``  — greedy step packing: start a new constant piece when
    ``y⁺_i − b_k > λ``; pack ``p`` pieces per node.
  * ``GBand(λ)``     — greedily extend a linear band while its width stays
    ``≤ λ`` (band through the group's first/last key-position points).
  * ``EBand(λ)``     — group pairs into equal-size position ranges and fit
    one band per group.

GStep and EBand are fully vectorized: the greedy grouping recurrence is
solved exactly with a jump table and frontier-doubling orbit extraction.
GBand keeps the paper's greedy semantics with a galloping feasibility
search per emitted node (a run of records wider than the band is taken
in one step, and short windows are tested element by element in Python,
with the same boundaries).  All builders assume non-overlapping, sorted
position ranges — true for data layers and all outlines.  Host-side numpy,
bit-identical to the JAX package's ``repro.core.builders``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .keyset import KeyPositions, POS_DTYPE
from .nodes import BandLayer, Layer, StepLayer
from .registry import (BUILDER_FAMILIES, register_builder,
                       register_multi_lam_builder)

_DELTA_SAFETY = 1.0  # absorbs float64 rounding so Eq.(1) holds bit-exactly
_SHORT_WINDOW = 32   # GBand windows up to this many records test in Python


def greedy_partition(lo: np.ndarray, hi: np.ndarray, lam: float,
                     switch: int = 8192) -> np.ndarray:
    """Greedy grouping of sorted ranges: group starting at ``s`` absorbs
    items while ``hi[i] − lo[s] ≤ λ``.  Returns group start indices
    (including 0), the exact greedy boundaries of paper §A.1 (1).

    ``jump[s] = first i with hi[i] > lo[s] + λ`` is a monotone map; the
    greedy boundaries are the orbit of 0 under ``jump``.  Few groups are
    walked boundary to boundary; past ``switch`` groups the rest of the
    orbit is extracted by frontier doubling in O(log G) vectorized rounds.
    ``switch`` only affects speed, never the boundaries.
    """
    n = len(lo)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    lam = np.float64(lam)

    hi_f = hi if hi.dtype == np.float64 else hi.astype(np.float64)
    lo_f = lo if lo.dtype == np.float64 else lo.astype(np.float64)
    walk = [0]
    s = 0
    while len(walk) <= switch:
        nxt = int(np.searchsorted(hi_f, lo_f[s] + lam, side="right"))
        nxt = min(max(nxt, s + 1), n)
        if nxt >= n:
            return np.asarray(walk, dtype=np.int64)
        walk.append(nxt)
        s = nxt

    # many groups: full jump table, orbit seeded from the walk's last
    # boundary (the doubling invariant needs a single seed point)
    targets = lo_f + lam
    jump = np.searchsorted(hi_f, targets, side="right").astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    jump = np.maximum(jump, idx + 1)          # ≥ one item per group
    jump = np.minimum(jump, n)
    jump = np.append(jump, n)                 # absorbing state
    orbit = np.asarray([s], dtype=np.int64)
    while orbit[-1] < n:
        nxt = jump[orbit]
        orbit = np.concatenate([orbit, nxt])
        if orbit[-1] >= n and np.all(nxt >= n):
            break
        jump = jump[jump]                     # square the jump map
    orbit = orbit[orbit < n]
    return np.concatenate([np.asarray(walk[:-1], dtype=np.int64),
                           np.unique(orbit)])


def check_disjoint(D: KeyPositions) -> None:
    """Builder precondition: non-overlapping sorted position ranges."""
    if D.n > 1:
        assert np.all(D.hi[:-1] <= D.lo[1:]), (
            "builders require non-overlapping position ranges")


def gstep_from_starts(D: KeyPositions, starts: np.ndarray, p: int) -> StepLayer:
    """A step layer from precomputed greedy piece boundaries."""
    piece_keys = D.keys[starts]
    piece_pos = np.empty(len(starts) + 1, dtype=POS_DTYPE)
    piece_pos[:-1] = D.lo[starts]
    piece_pos[-1] = D.hi[-1]
    P = len(starts)
    node_off = np.arange(0, P, p, dtype=np.int64)
    node_off = np.append(node_off, P)
    return StepLayer(piece_keys=piece_keys, piece_pos=piece_pos,
                     node_piece_off=node_off)


def build_gstep(D: KeyPositions, p: int, lam: float) -> StepLayer:
    """Greedy step builder (paper §A.1 (1)) — exact, fully vectorized."""
    check_disjoint(D)
    starts = greedy_partition(D.lo_f, D.hi_f, lam)      # piece start indices
    return gstep_from_starts(D, starts, p)


def fit_bands_for_groups(D: KeyPositions, starts: np.ndarray) -> BandLayer:
    """Fit one band per group (line through first/last midpoints, width =
    max residual + safety).  Vectorized with segment reductions."""
    ends = np.append(starts[1:], D.n)
    first, last = starts, ends - 1
    mid = D.mid_f
    x1 = D.keys[first]
    y1 = mid[first]
    dx = D.keys_f[last] - D.keys_f[first]
    dy = mid[last] - mid[first]
    m = np.where(dx > 0, dy / np.maximum(dx, 1.0), 0.0)
    gid = np.repeat(np.arange(len(starts)), ends - starts)
    line = y1[gid] + m[gid] * (D.keys_f - x1[gid].astype(np.float64))
    resid = np.maximum(line - D.lo_f, D.hi_f - line)
    delta = np.maximum.reduceat(resid, starts) + _DELTA_SAFETY
    return BandLayer(
        node_keys=D.keys[first].astype(np.uint64),
        x1=D.keys[first].astype(np.uint64),
        y1=np.rint(y1).astype(POS_DTYPE),
        m=m,
        delta=delta + 1.0,  # covers the rint() on y1
        clamp_lo=int(D.lo[0]),
        clamp_hi=int(D.hi[-1]),
    )


def _eband_starts(D: KeyPositions, lam: float) -> np.ndarray:
    lam = max(float(lam), 1.0)
    cell = ((D.lo_f - float(D.lo[0])) // lam).astype(np.int64)
    return np.flatnonzero(np.diff(cell, prepend=cell[0] - 1))


def build_eband(D: KeyPositions, lam: float) -> BandLayer:
    """Equal-position-range band builder (paper §A.1 (3)) — vectorized.
    Groups by the position grid ``⌊(y⁻ − y⁻_0)/λ⌋``."""
    check_disjoint(D)
    return fit_bands_for_groups(D, _eband_starts(D, lam))


def _gband_starts(D: KeyPositions, lam: float) -> np.ndarray:
    n = D.n
    keys_f = D.keys_f
    lo_f = D.lo_f
    hi_f = D.hi_f
    mid = D.mid_f
    half = 0.5 * float(lam)

    # the same arrays read one Python float at a time where a window is
    # short (numpy's per-call cost would dominate); the same IEEE
    # operations in the same order, so the same answers
    ka, la, ha, ma = (memoryview(np.ascontiguousarray(a, dtype=np.float64))
                      for a in (keys_f, lo_f, hi_f, mid))

    def feasible(s: int, e: int) -> bool:
        """Band through midpoints of s and e−1 has width 2δ ≤ λ?"""
        if e - s <= 1:
            return True
        if e - s <= _SHORT_WINDOW:
            k0, m0 = ka[s], ma[s]
            dx = ka[e - 1] - k0
            m = (ma[e - 1] - m0) / dx if dx > 0 else 0.0
            for j in range(s, e):
                line = m0 + m * (ka[j] - k0)
                r = line - la[j]
                b = ha[j] - line
                # the window's largest residual only grows: one too wide
                # decides it
                if (r if r > b else b) + _DELTA_SAFETY > half:
                    return False
            return True
        dx = keys_f[e - 1] - keys_f[s]
        m = (mid[e - 1] - mid[s]) / dx if dx > 0 else 0.0
        line = mid[s] + m * (keys_f[s:e] - keys_f[s])
        resid = np.maximum(line - lo_f[s:e], hi_f[s:e] - line)
        return float(resid.max()) + _DELTA_SAFETY <= half

    # A band over two or more records passes every record at a distance of
    # at least half its width, so a record wider than the band (by a margin
    # far above float64 rounding) ends the group before it and is a group of
    # its own.  Where s or s + 1 is such a record, the group at s is [s,
    # s + 1), as the gallop below finds; a run of them is taken at once.
    # (At λ under the record size every record is one: one gallop each
    # would take the build.)
    margin = 1e-6 * (half + 1.0)
    wide = 0.5 * (hi_f - lo_f) > half - _DELTA_SAFETY + margin
    alone = wide.copy()
    alone[:-1] |= wide[1:]
    alone[-1] = True
    grouped = np.flatnonzero(~alone)

    starts = [0]
    s = 0
    guess = 64
    while True:
        if alone[s]:
            t = grouped[np.searchsorted(grouped, s)] \
                if grouped.size and grouped[-1] > s else n
            starts.extend(range(s + 1, min(t, n - 1) + 1))
            if t >= n:
                break
            s, guess = t, 1
        # gallop to bracket the maximal feasible end
        step = max(guess, 2)
        e_ok = s + 1
        e = min(s + step, n)
        while e > e_ok and feasible(s, e):
            e_ok = e
            if e == n:
                break
            step *= 4
            e = min(s + step, n)
        # binary search in (e_ok, e)
        bad = e if e > e_ok else e_ok
        while bad - e_ok > 1:
            probe = (e_ok + bad) // 2
            if feasible(s, probe):
                e_ok = probe
            else:
                bad = probe
        guess = e_ok - s
        if e_ok >= n:
            break
        starts.append(e_ok)
        s = e_ok
    return np.asarray(starts, dtype=np.int64)


def build_gband(D: KeyPositions, lam: float) -> BandLayer:
    """Greedy band builder (paper §A.1 (2)): extend each group while the
    band width ``2δ`` stays ≤ λ."""
    check_disjoint(D)
    return fit_bands_for_groups(D, _gband_starts(D, lam))


# ---------------------------------------------------------------------------
# builder objects + the Eq.(8) grid
# ---------------------------------------------------------------------------
# The built-in families, registered so the Alg. 2 search resolves them (and
# any third-party family registered through the registry) by one mechanism.
@register_builder("gstep")
def _gstep_family(D: KeyPositions, lam: float, p: int) -> Layer:
    return build_gstep(D, int(p), lam)


@register_builder("gband")
def _gband_family(D: KeyPositions, lam: float, p: int) -> Layer:
    return build_gband(D, lam)


@register_builder("eband")
def _eband_family(D: KeyPositions, lam: float, p: int) -> Layer:
    return build_eband(D, lam)


# ---------------------------------------------------------------------------
# fused multi-λ entry points (the sweep engine's fast path, §Eq. 8)
# ---------------------------------------------------------------------------
# One call builds a family's whole λ-column for a vertex.  Shared work:
# the float64 views (lo_f/hi_f/keys_f/mid_f) convert once per collection
# (cached on D), and λ values resolving to the SAME partition — common on
# small outline collections where the grid saturates — share one layer
# object, so band fitting / step construction run once per unique
# boundary set.  NOTE greedy boundaries are *not* nested across λ (a
# coarse boundary need not survive at a finer λ), so every λ's boundaries
# are still computed exactly; only construction downstream of identical
# boundaries is deduplicated.  Each element is bit-identical to the
# single-λ build at that λ.
def _dedup_by_starts(D: KeyPositions, lams, starts_fn, construct):
    layers, by_starts = [], {}
    for lam in lams:
        starts = starts_fn(D, lam)
        key = starts.tobytes()
        layer = by_starts.get(key)
        if layer is None:
            layer = construct(starts)
            by_starts[key] = layer
        layers.append(layer)
    return layers


@register_multi_lam_builder("gstep")
def build_gstep_multi(D: KeyPositions, lams, p: int) -> list:
    check_disjoint(D)
    lo_f, hi_f = D.lo_f, D.hi_f       # one float64 conversion for all λ
    return _dedup_by_starts(
        D, lams, lambda d, lam: greedy_partition(lo_f, hi_f, lam),
        lambda starts: gstep_from_starts(D, starts, int(p)))


@register_multi_lam_builder("gband")
def build_gband_multi(D: KeyPositions, lams, p: int) -> list:
    check_disjoint(D)
    return _dedup_by_starts(D, lams, _gband_starts,
                            lambda starts: fit_bands_for_groups(D, starts))


@register_multi_lam_builder("eband")
def build_eband_multi(D: KeyPositions, lams, p: int) -> list:
    check_disjoint(D)
    return _dedup_by_starts(D, lams, _eband_starts,
                            lambda starts: fit_bands_for_groups(D, starts))


DEFAULT_FAMILIES = ("gstep", "gband", "eband")   # the paper's deployed set


@dataclasses.dataclass(frozen=True)
class LayerBuilder:
    """A node builder F ∈ 𝓕 mapping a key-position collection to a layer.

    ``kind`` names a family in :data:`repro_torch.core.registry.BUILDER_FAMILIES`;
    resolution happens per call, so families registered after construction
    (e.g. from test or plugin code) are picked up live.
    """

    kind: str          # a registered family name ('gstep' | 'gband' | …)
    lam: float
    p: int = 16        # pieces per node (gstep only)

    @property
    def name(self) -> str:
        if self.kind == "gstep":
            return f"GStep({self.p},{int(self.lam)})"
        if self.kind in ("gband", "eband"):
            return f"{'GBand' if self.kind == 'gband' else 'EBand'}({int(self.lam)})"
        return f"{self.kind}({int(self.lam)})"

    def __call__(self, D: KeyPositions) -> Layer:
        return BUILDER_FAMILIES.get(self.kind)(D, self.lam, self.p)


def make_builders(lam_low: float = 2**8, lam_high: float = 2**20,
                  base: float = 2.0, p: int = 16,
                  kinds=DEFAULT_FAMILIES) -> list[LayerBuilder]:
    """Granularity exponentiation (Eq. 8): λ_low, λ_low·(1+ε), …, λ_high.

    ``kinds`` are family names resolved through the builder registry;
    unknown names raise ``KeyError`` listing what is registered.
    """
    if not base > 1.0:       # a real raise: base <= 1 never terminates
        raise ValueError(f"grid base must be > 1, got {base}")
    if kinds is None:
        kinds = DEFAULT_FAMILIES
    for k in kinds:
        BUILDER_FAMILIES.get(k)        # fail fast on unknown families
    lams = []
    lam = float(lam_low)
    while lam <= lam_high * (1 + 1e-9):
        lams.append(lam)
        lam *= base
    return [LayerBuilder(kind=k, lam=l, p=p) for k in kinds for l in lams]


# ---------------------------------------------------------------------------
# data-partitioned building (paper §5.4 "From Data Partitioning")
# ---------------------------------------------------------------------------
def merge_layers(parts: list[Layer]) -> Layer:
    """Merge per-partition layers into one (piecewise functions concatenate)."""
    assert parts
    if isinstance(parts[0], StepLayer):
        piece_keys = np.concatenate([q.piece_keys for q in parts])
        piece_pos = np.concatenate(
            [q.piece_pos[:-1] for q in parts] + [parts[-1].piece_pos[-1:]])
        offs = [parts[0].node_piece_off]
        acc = parts[0].n_pieces
        for q in parts[1:]:
            offs.append(q.node_piece_off[1:] + acc)
            acc += q.n_pieces
        return StepLayer(piece_keys=piece_keys, piece_pos=piece_pos,
                         node_piece_off=np.concatenate(offs))
    return BandLayer(
        node_keys=np.concatenate([q.node_keys for q in parts]),
        x1=np.concatenate([q.x1 for q in parts]),
        y1=np.concatenate([q.y1 for q in parts]),
        m=np.concatenate([q.m for q in parts]),
        delta=np.concatenate([q.delta for q in parts]),
        clamp_lo=min(q.clamp_lo for q in parts),
        clamp_hi=max(q.clamp_hi for q in parts),
    )


def build_partitioned(builder: LayerBuilder, D: KeyPositions,
                      partition_pairs: int = 1_000_000) -> Layer:
    """Build per 1M-pair partition and merge (paper's default partitioning).

    Partitions build sequentially, on the host.
    """
    if D.n <= partition_pairs:
        return builder(D)
    parts = []
    for s in range(0, D.n, partition_pairs):
        parts.append(builder(D.slice(s, min(s + partition_pairs, D.n))))
    return merge_layers(parts)
