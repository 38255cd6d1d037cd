"""Fused λ-grid candidate sweep engine — the Alg. 2 inner loop, batched.

:class:`SweepEngine` replaces the per-builder loop of every search strategy
with one fused "score all children of D" operation, as in the JAX
package's ``repro.core.sweep``:

  1. **multi-λ building** — each family's whole Eq. (8) λ-column builds in
     one call (``MULTI_LAM_FAMILIES``); λ values that resolve to identical
     partitions share one layer object.  Families registered only in
     ``BUILDER_FAMILIES`` fall back to per-λ builds.
  2. **batched scoring** — all surviving candidates' sampled widths stack
     into one (U, SCORE_SAMPLE) matrix and ``Ê[T(Δ)]`` evaluates for every
     candidate in one call.  ``score_backend="cuda"`` (the default) moves
     the matrix to the engine's device as one contiguous float32 tensor
     and scores it there — the hand-written kernel on a card
     (:mod:`repro_torch.kernels.candidate_score`), its plain PyTorch
     version on the CPU — for affine-representable tiers;
     ``"numpy"`` is the reference's exact float64 ranking.  Exact Eq. (6)
     costs always use the numpy float64 path, so returned designs and
     costs stay exact.
  3. **memoization** — whole expansions are cached per collection
     fingerprint (``_VertexSweep``), and the profile-independent
     layer/outline pairs live in a :class:`LayerCache` keyed by
     (fingerprint, builder) that can be SHARED across strategy
     invocations (``TuneStats.layers_reused`` / ``sweeps`` count it).

Bit-identity contract: with ``score_backend="numpy"``, every candidate's
layer arrays, outline, est/exact read cost and τ̂ equal the JAX package's
bit for bit.  Under ``"cuda"`` the float32 estimates may reorder
near-ties; the returned cost is still exactly Eq. (6) of the returned
design.

Tail-latency objectives ride through unchanged: the strategies wrap the
tier in an :class:`~repro_torch.core.storage.ObjectiveProfile`, and the
engine's score memos are keyed by the profile object, so one LayerCache
serves mean- and quantile-objective tunes — layer builds are shared,
scores are kept apart per objective.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.kernels._cuda import REFERENCE_BACKENDS, resolve_device

from .complexity import tau_hat
from .keyset import KeyPositions
from .latency import batched_mean_read_costs
from .nodes import Layer, outline
from .registry import BUILDER_FAMILIES, MULTI_LAM_FAMILIES
from .storage import StorageProfile, affine_coefficients

SCORE_SAMPLE = 65536   # pairs used for candidate *ranking* (§5.3); the
                       # selected candidates' costs are always exact

#: ranking backends: the float32 device scorer on the engine's device, or
#: the exact float64 numpy evaluator
SCORE_BACKENDS = ("cuda", "numpy")


@dataclasses.dataclass
class Candidate:
    """One outgoing edge of a search vertex: apply builder → next layer."""

    order: int             # position in the caller's builder list (tie-break)
    name: str              # F.name — TuneResult.builder_names provenance
    layer: Layer
    outline: KeyPositions  # the vertex this edge leads to (Alg. 2 line 5)
    est_cost: float        # sampled Ê[T(Δ)] — ranking only
    tau: float             # τ̂(outline; T), Eq. (12)
    entry: object = None   # backing _LayerEntry (score memo host)

    @property
    def score(self) -> float:
        """Eq. (9) selection score (same addition order as the legacy loop)."""
        return self.tau + self.est_cost


@dataclasses.dataclass
class _VertexSweep:
    cands: list            # shrinking Candidates, in builder-list order
    n_nonshrink: int       # edges discarded by the termination safeguard


@dataclasses.dataclass
class _LayerEntry:
    layer: object                   # the built Layer
    outline: object = None          # its outline, filled on first need
    # (profile key, "exact"|"est") -> E[T(Δ)].  When the vertex is small
    # enough that the §5.3 ranking subsample IS the full key set (n ≤
    # 2·SCORE_SAMPLE), the estimate equals the exact Eq. (6) expectation
    # bit-for-bit and both share the "exact" slot — so a brute-force
    # certification pass warms every guided strategy's ranking for free.
    scores: dict = dataclasses.field(default_factory=dict)


#: default entry cap for long-lived caches: an observe→retune loop keeps
#: one cache alive across every retune generation, so it must be bounded —
#: 64k entries comfortably hold several full tunes while capping
#: worst-case residency
DEFAULT_CACHE_ENTRIES = 65536


class LayerCache:
    """Profile-independent build memo: (collection fingerprint, builder)
    → layer (+ outline, lazily).

    λ-grid and vertex sweeps inside ONE tune always go through a cache
    (engines make a private one by default); passing an explicit cache to
    several strategy invocations extends the reuse across them — tuning
    one dataset for several storage tiers, certifying several strategies
    against each other, or warm-starting a re-tune after a profile change
    all rebuild zero layers for already-expanded collections.  The
    layer/outline pairs are T(Δ)-independent; the est/exact/τ̂ memos
    travel WITH the cached
    entries but are keyed per profile (``_LayerEntry.scores``), so
    sharing a cache across tiers can never alias costs between profiles
    — while re-tuning the same tier skips rescoring entirely.

    ``max_entries`` bounds the memo (insertion-order eviction via
    :meth:`trim`, called by the sweep engine after each expansion):
    evicting an entry only costs a rebuild on the next miss, so
    long-running retune loops stay memory-bounded.  ``None`` (default)
    keeps the historical unbounded behavior for single-tune engines.
    """

    def __init__(self, max_entries: int | None = None):
        from collections import OrderedDict
        self._entries: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self._pinned_profiles: list = []   # see pin_profile

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._pinned_profiles.clear()

    def trim(self) -> None:
        """Evict oldest-inserted entries beyond ``max_entries``."""
        if self.max_entries is not None:
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def pin_profile(self, profile) -> tuple:
        """Score-memo key for an *unhashable* profile.  Pinning a strong
        reference for the cache's lifetime keeps ``id(profile)`` unique —
        otherwise a garbage-collected profile's address could be reused
        and silently alias another profile's memoized costs."""
        self._pinned_profiles.append(profile)
        return ("unhashable-profile", id(profile))


def seed_layer_cache(cache: LayerCache, D: KeyPositions, seed_layers,
                     builders: list) -> list:
    """Warm-start seeding: inject a previous design's layers into a
    :class:`LayerCache` keyed exactly as the builders that would rebuild
    them, so the next search gets cache hits along the old design's path
    instead of rebuilding it (ROADMAP: incremental re-tune on drift).

    ``seed_layers`` is the previous design bottom-up as ``(builder_name,
    layer)`` pairs — ``TuneResult.builder_names`` zipped with
    ``design.layers``, or the recovered equivalents of a disk-opened index
    (recovered from an index file).  Layers whose recorded name matches no
    builder in ``builders`` stop the chain (the collections above them
    would no longer line up with search vertices).

    The caller guarantees each seed layer is bit-identical to what its
    named builder would build on its collection (builders are
    deterministic, so in-memory results always qualify; disk recovery
    must canonicalize first) — a violated guarantee would poison the
    memo with a layer the search believes it built.

    Returns the seeded chain as ``(name, layer, collection, outline)``
    tuples (used by the beam strategy to inject initial vertices).
    """
    by_name = {b.name: b for b in builders}
    chain = []
    cur = D
    for name, layer in seed_layers:
        b = by_name.get(name)
        if b is None or b.kind not in BUILDER_FAMILIES:
            break
        canon = getattr(BUILDER_FAMILIES.get(b.kind), "canonical_lam", None)
        lam = canon(cur, b.lam) if canon else b.lam
        key = (cur.fingerprint, b.kind, lam, b.p)
        out = None
        entry = cache._entries.get(key)
        if entry is None:
            out = outline(layer, cur)
            cache._entries[key] = _LayerEntry(layer, outline=out)
        else:                       # already cached (e.g. a shared cache
            if entry.outline is None:   # from the original tune)
                entry.outline = outline(entry.layer, cur)
            out = entry.outline
            layer = entry.layer
        chain.append((name, layer, cur, out))
        cur = out
    cache.trim()
    return chain


def resolve_score_backend(score_backend: str, device=None) -> tuple:
    """The ranking backend of a tune and the device it ranks on →
    ``(backend, device)``.  The JAX package's ``"pallas"`` and ``"jnp"``
    read as ``"cuda"``; under ``"cuda"`` the device is the card unless
    the caller names another, and with no card and no device named this
    raises.  ``"numpy"`` ranks on the host (device ``None``)."""
    score_backend = REFERENCE_BACKENDS.get(score_backend, score_backend)
    if score_backend not in SCORE_BACKENDS:
        raise ValueError(f"score_backend must be one of {SCORE_BACKENDS},"
                         f" got {score_backend!r}")
    return score_backend, (resolve_device(device)
                           if score_backend == "cuda" else None)


class SweepEngine:
    """Per-tune candidate factory shared by all search strategies.

    One engine instance lives for one strategy invocation (fixed builder
    list + storage profile), so its vertex cache never crosses profiles.

    ``score_backend="cuda"`` ranks on ``device`` (see
    :func:`resolve_score_backend`): with no card and no device named the
    engine raises, even for an exhaustive strategy that never ranks.
    """

    def __init__(self, builders: list, profile: StorageProfile,
                 stats, *, score_backend: str = "cuda",
                 rank_scores: bool = True,
                 layer_cache: LayerCache | None = None, device=None):
        self.score_backend, self.device = resolve_score_backend(
            score_backend, device)
        # the tier's (ℓ, 1/B) when the device ranks it; None ranks in numpy
        self._affine = affine_coefficients(profile) \
            if self.score_backend == "cuda" else None
        self.builders = list(builders)
        self.profile = profile
        self.stats = stats
        # exhaustive strategies never rank by Eq. (9): skip Ê[T(Δ)] + τ̂
        self.rank_scores = rank_scores
        self.layer_cache = layer_cache if layer_cache is not None \
            else LayerCache()
        try:                       # score-memo key: equal profiles share
            hash(profile)
            self._pk = profile
        except TypeError:
            self._pk = self.layer_cache.pin_profile(profile)
        self._vertices: dict[bytes, _VertexSweep] = {}
        # family columns: (kind, p) -> ordered builder indices; preserves
        # the caller's builder order inside each column
        cols: dict[tuple, list[int]] = {}
        for i, b in enumerate(self.builders):
            cols.setdefault((b.kind, b.p), []).append(i)
        self._columns = list(cols.items())

    # -- warm-start seeding --------------------------------------------------
    def seed(self, D: KeyPositions, seed_layers) -> list:
        """Inject a previous design into this engine's layer cache (see
        :func:`seed_layer_cache`); counts the injected layers in
        ``TuneStats.layers_seeded``."""
        chain = seed_layer_cache(self.layer_cache, D, seed_layers,
                                 self.builders)
        self.stats.layers_seeded += len(chain)
        return chain

    # -- candidate expansion -------------------------------------------------
    def children(self, D: KeyPositions) -> list[Candidate]:
        """All shrinking candidates of vertex ``D``, scored, in builder
        order.  Memoized on the collection's content fingerprint."""
        fp = D.fingerprint
        hit = self._vertices.get(fp)
        if hit is not None:
            # a legacy revisit would have rebuilt + re-pruned everything
            self.stats.layers_reused += len(self.builders)
            self.stats.candidates_pruned += hit.n_nonshrink
            return hit.cands
        t0 = time.perf_counter()
        vs = self._expand(D)
        self._vertices[fp] = vs
        self.stats.sweeps += 1
        self.stats.sweep_seconds += time.perf_counter() - t0
        return vs.cands

    def _expand(self, D: KeyPositions) -> _VertexSweep:
        stats = self.stats
        fp = D.fingerprint
        lc = self.layer_cache._entries
        entries: list = [None] * len(self.builders)
        for (kind, p), idxs in self._columns:
            # a registered family may canonicalize λ (e.g. rmi_leaf maps
            # λ → its clamped model count): builders whose λ values
            # canonicalize alike share one cache entry and one build
            canon = getattr(BUILDER_FAMILIES.get(kind), "canonical_lam",
                            None) if kind in BUILDER_FAMILIES else None

            def _key(i):
                lam = self.builders[i].lam
                return (fp, kind, canon(D, lam) if canon else lam, p)

            missing = []
            for i in idxs:
                e = lc.get(_key(i))
                if e is not None:       # built by an earlier tune/vertex
                    entries[i] = e
                    stats.layers_reused += 1
                else:
                    missing.append(i)
            if not missing:
                continue
            if kind in MULTI_LAM_FAMILIES:
                built = MULTI_LAM_FAMILIES.get(kind)(
                    D, [self.builders[i].lam for i in missing], p)
            else:                       # single-λ-only family: legacy builds
                built, by_ck = [], {}
                for i in missing:
                    ck = _key(i)
                    layer = by_ck.get(ck)
                    if layer is None:   # canonical-λ duplicates build once
                        layer = by_ck[ck] = self.builders[i](D)
                    built.append(layer)
            made: dict[int, _LayerEntry] = {}
            for i, layer in zip(missing, built):
                e = made.get(id(layer))
                if e is None:           # λ values sharing a partition share
                    e = made[id(layer)] = _LayerEntry(layer)   # one entry
                    stats.layers_built += 1
                else:
                    stats.layers_reused += 1
                lc[_key(i)] = e
                entries[i] = e
        self.layer_cache.trim()     # bounded caches evict oldest entries
        #                             (local `entries` refs keep this
        #                             expansion's layers alive regardless)

        # shrink guard for every candidate in one vectorized comparison
        # (outline extent == layer.size_bytes: outlines span the serialized
        # layer, so the guard needs no outline construction for losers)
        sizes = np.fromiter((e.layer.size_bytes for e in entries),
                            dtype=np.int64, count=len(entries))
        shrinking = sizes < D.size_bytes
        n_nonshrink = int(np.count_nonzero(~shrinking))
        stats.candidates_pruned += n_nonshrink

        # outline once per unique surviving layer (cached cross-engine)
        survivors = [i for i in range(len(entries)) if shrinking[i]]
        uniq: list[_LayerEntry] = []
        seen: set[int] = set()
        for i in survivors:
            if id(entries[i]) not in seen:
                seen.add(id(entries[i]))
                uniq.append(entries[i])
        for e in uniq:
            if e.outline is None:
                e.outline = outline(e.layer, D)

        # Eq. (9) ranking terms, memoized per (entry, profile).  When the
        # §5.3 subsample is the full key set and the backend is numpy, the
        # estimate IS the exact Eq. (6) expectation — share its slot, so a
        # prior exact pass (e.g. a brute-force certification run on the
        # same cache) makes ranking free, and vice versa.  A float32 cuda
        # estimate never shares the exact slot.
        pk = self._pk
        tau_by: dict[int, float] = {}
        est_by: dict[int, float] = {}
        if self.rank_scores:
            full = D.n <= 2 * SCORE_SAMPLE
            est_slot = (pk, "exact") if full and self.score_backend == "numpy" \
                else (pk, "est", self.score_backend)
            for e in uniq:
                t = e.scores.get((pk, "tau"))
                if t is None:
                    t = tau_hat(e.outline, self.profile)
                    e.scores[(pk, "tau")] = t
                tau_by[id(e)] = t
            to_score = [e for e in uniq if est_slot not in e.scores]
            if to_score:
                # batched sampled Ê[T(Δ)]: ONE (U, S) matrix for all layers
                keys, weights = _score_sample(D)
                W = np.stack([e.layer.widths_at(keys) for e in to_score])
                est = self._batched_est(W, weights)
                stats.candidates_scored += len(to_score)
                for e, v in zip(to_score, est):
                    e.scores[est_slot] = float(v)
            for e in uniq:
                est_by[id(e)] = e.scores[est_slot]
        else:                       # exhaustive strategies never rank
            for e in uniq:
                tau_by[id(e)] = est_by[id(e)] = float("nan")

        cands = [Candidate(order=i, name=self.builders[i].name,
                           layer=entries[i].layer,
                           outline=entries[i].outline,
                           est_cost=est_by[id(entries[i])],
                           tau=tau_by[id(entries[i])],
                           entry=entries[i])
                 for i in survivors]
        return _VertexSweep(cands=cands, n_nonshrink=n_nonshrink)

    def _batched_est(self, W: np.ndarray, weights: np.ndarray) -> np.ndarray:
        if self._affine is None:    # numpy ranking, or a tier with no
            #                         device closed form: exact float64
            return batched_mean_read_costs(W, weights, self.profile)
        # imported here: the scorer's dispatch imports core.latency and
        # core.storage, so a top-level import would be circular
        from repro_torch.kernels.candidate_score import timed_affine_scores
        est, (copy_s, kernel_s, readback_s) = timed_affine_scores(
            W, weights, *self._affine, device=self.device)
        stats = self.stats
        stats.est_batches += 1
        stats.est_copy_seconds += copy_s
        stats.est_kernel_seconds += kernel_s
        stats.est_readback_seconds += readback_s
        return est

    # -- exact (Eq. 6) read costs -------------------------------------------
    def exact_read_costs(self, D: KeyPositions,
                         cands: list[Candidate]) -> list[float]:
        """Exact ``E_x[T(Δ)]`` over ALL of D's weighted keys, for the
        selected candidates — batched into one matrix, memoized per
        (entry, profile).  Always numpy float64: returned designs/costs
        must stay exactly Eq. (6) regardless of the ranking backend."""
        pk = self._pk
        missing, seen = [], set()
        for c in cands:
            eid = id(c.entry)
            if (pk, "exact") not in c.entry.scores and eid not in seen:
                missing.append(c)
                seen.add(eid)
        if missing:
            W = np.stack([c.layer.widths_at(D.keys) for c in missing])
            costs = batched_mean_read_costs(W, D.weights, self.profile)
            for c, v in zip(missing, costs):
                c.entry.scores[(pk, "exact")] = float(v)
            self.stats.candidates_scored += len(missing)
        return [c.entry.scores[(pk, "exact")] for c in cands]


def _score_sample(D: KeyPositions) -> tuple[np.ndarray, np.ndarray]:
    """The strided ranking subsample — same rule as the legacy
    ``_mean_layer_read_cost(..., sample=True)`` path."""
    if D.n > 2 * SCORE_SAMPLE:
        stride = D.n // SCORE_SAMPLE
        return D.keys[::stride], D.weights[::stride]
    return D.keys, D.weights
