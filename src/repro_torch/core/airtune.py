"""AirTune — guided graph search with bounded visits (paper §5, Alg. 2).

Vertices are key-position collections (the origin is the data layer); an
edge applies a layer builder ``F ∈ 𝓕`` and moves to the layer's outline.
The value function solved here is exactly Alg. 2's recursion:

    V(D) = min( T(s_D),                                  # stop: D is root
                min_{Θ_next} E_X[T(Δ(x; Θ_next))] + V(outline(Θ_next)) )

with two paper mechanisms bounding the visit count:

  * **stopping criterion** (Alg. 2 lines 1–2): if reading all of ``D``
    already beats an *ideal* extra layer (1-byte root + 1-byte precise
    read), stop — no real layer can help;
  * **top-k selection** (Eq. 9): recurse only into the k candidates with
    the smallest ``τ̂(D_next; T) + E_X[T(Δ(x; Θ_next))]``.

Exactness of the expectation: step widths are constant per piece and band
widths constant per node, and piece/node boundaries are drawn from the
collection's keys, so evaluating widths at outline keys with aggregated
weights equals evaluating at the original query keys (see latency.py).

Candidate expansion runs through the fused sweep engine
(:class:`repro_torch.core.sweep.SweepEngine`): per vertex, every family's
λ-column builds in one multi-λ call, all candidates score in one batched
``E[T(Δ)]`` evaluation — on the card by default (``score_backend="cuda"``,
the hand-written candidate-scoring kernel), or in float64 numpy
(``score_backend="numpy"``, bit-identical to the JAX package) — and
expansions are memoized by collection fingerprint.  ``sweep=False`` keeps
the original per-builder loop as a bit-identical reference.

Three :class:`SearchStrategy` implementations share this machinery and are
registered in :data:`repro_torch.core.registry.SEARCH_STRATEGIES`:

  * :func:`airtune`     — the paper's guided depth-first search (Alg. 2);
  * :func:`brute_force` — exhaustive reference (no pruning, no τ̂);
  * :func:`beam_search` — breadth-first with a width-``k`` frontier; same
    stopping criterion and Eq. 9 score, but total layer builds bounded by
    ``max_layers · k · |𝓕|`` (predictable tuning cost on huge 𝓕).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol

import numpy as np

from .builders import LayerBuilder, make_builders
from .complexity import tau_hat
from .keyset import KeyPositions
from .latency import IndexDesign, expected_latency, ideal_latency_with_index
from .nodes import Layer, outline
from .registry import register_strategy
from .storage import StorageProfile, normalize_objective, objective_profile
from .sweep import (SCORE_SAMPLE, LayerCache, SweepEngine,
                    resolve_score_backend)


@dataclasses.dataclass
class TuneStats:
    vertices_visited: int = 0
    layers_built: int = 0        # candidate layers actually constructed
    layers_reused: int = 0       # builds avoided: λ-dedup + vertex memo hits
    layers_seeded: int = 0       # warm-start: previous-design layers injected
    candidates_pruned: int = 0   # discarded without recursion: non-shrinking
    #                              outlines + beyond-top-k (guided searches)
    candidates_scored: int = 0   # E[T(Δ)] evaluations performed (est + exact)
    sweeps: int = 0              # fused children-of-vertex expansions
    sweep_seconds: float = 0.0   # wall-clock inside those expansions
    wall_seconds: float = 0.0
    # the device ranking (score_backend="cuda"): batched estimate calls
    # that went to the device scorer, and their wall split into the
    # float32 cast + host→device copy, the synchronised launch and the
    # readback
    est_batches: int = 0
    est_copy_seconds: float = 0.0
    est_kernel_seconds: float = 0.0
    est_readback_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class TuneResult:
    design: IndexDesign
    cost: float               # the objective's value on design: Eq. (6) for
    #                           "mean", E[T] + w·Q̂_p[T] for quantile tuning
    stats: TuneStats
    strategy: str = "airtune"          # which SearchStrategy produced this
    builder_names: tuple = ()          # provenance: F.name per layer, bottom-up
    objective: object = "mean"         # "mean" | {"p": q, "weight": w}

    def describe(self) -> str:
        return (f"[{self.strategy}] {self.design.describe()}  "
                f"cost={self.cost * 1e6:.1f}us  "
                f"(visited={self.stats.vertices_visited}, "
                f"built={self.stats.layers_built}, "
                f"reused={self.stats.layers_reused}, "
                f"pruned={self.stats.candidates_pruned}, "
                f"{self.stats.wall_seconds:.2f}s)")


class SearchStrategy(Protocol):
    """Protocol every registered search strategy implements.

    ``builders=None`` means the default Eq. (8) grid; ``k`` is the
    strategy's width/pruning knob (ignored by exhaustive strategies) and
    ``max_layers`` bounds the index depth.  Implementations must return a
    :class:`TuneResult` whose ``cost`` agrees with the Eq. (6) evaluator
    on the returned design.  The built-in strategies additionally accept
    ``sweep`` (False = legacy per-builder loop), ``score_backend``
    (``"cuda"`` default: float32 ranking on ``device``, the card unless
    named | ``"numpy"``: exact float64 ranking; the JAX package's
    ``"pallas"`` and ``"jnp"`` read as ``"cuda"``), ``device``,
    ``layer_cache`` (a shared :class:`repro_torch.core.sweep.LayerCache` for
    cross-tune build reuse), ``seed_layers`` (warm-start: a previous
    design as ``(builder_name, layer)`` pairs, injected into the cache —
    and, for ``beam``, the initial frontier) and ``objective``
    (None/"mean" | ``{"p": q, "weight": w}`` tail-latency objective);
    third-party strategies need not.
    """

    def __call__(self, D: KeyPositions, profile: StorageProfile,
                 builders: list[LayerBuilder] | None = None, *,
                 k: int = 5, max_layers: int = 12) -> TuneResult: ...


def _mean_layer_read_cost(layer: Layer, D: KeyPositions,
                          profile: StorageProfile,
                          sample: bool = False) -> float:
    """E_{x∼X}[T(Δ(x; Θ))] over D's weighted keys.

    ``sample=True``: strided subsample for ranking-only estimates — exact
    evaluation of all |𝓕| candidates cost O(|𝓕|·n·log) per vertex and
    dominated tuning time (see the batched scorers in latency.py/sweep.py).
    """
    if sample and D.n > 2 * SCORE_SAMPLE:
        stride = D.n // SCORE_SAMPLE
        keys = D.keys[::stride]
        weights = D.weights[::stride]
    else:
        keys, weights = D.keys, D.weights
    wq = layer.widths_at(keys)
    return float(np.average(profile(wq), weights=weights))


def _require_sweep_for_seed(seed_layers, sweep: bool) -> None:
    if seed_layers and not sweep:
        raise ValueError("warm-start seeding (seed_layers) requires the "
                         "sweep engine; call with sweep=True")


def _objective_field(objective):
    """Normalized provenance value recorded on TuneResult."""
    norm = normalize_objective(objective)
    return "mean" if norm is None else {"p": norm[0], "weight": norm[1]}


@register_strategy("airtune")
def airtune(D: KeyPositions, profile: StorageProfile,
            builders: list[LayerBuilder] | None = None, *,
            k: int = 5, max_layers: int = 12, sweep: bool = True,
            score_backend: str = "cuda",
            layer_cache: LayerCache | None = None,
            seed_layers=None, objective=None, device=None) -> TuneResult:
    """Find Θ* ≈ argmin_Θ L_SM(X; Θ, T) (Table 3) via Alg. 2.

    ``seed_layers`` (warm start: a previous design as bottom-up
    ``(builder_name, layer)`` pairs) pre-populates the layer cache along
    the old design's path — pure memoization, so the returned design is
    bit-identical to a cold search with strictly fewer builds (the
    warm-vs-cold identity test certifies this).

    ``objective`` (None/"mean" default, or ``{"p": q, "weight": w}``)
    selects the cost the search minimizes: the mean objective runs on
    ``profile`` itself (bit-identical to the pre-objective search); a
    quantile objective swaps in the
    :class:`~repro_torch.core.storage.ObjectiveProfile` cost curve so the
    unchanged Alg. 2 recursion ranks designs by ``E[T] + w·Q̂_p[T]``.
    """
    # the legacy loop ranks in numpy, but the caller's backend and device
    # are checked on both paths: no card and no device named raises
    score_backend, device = resolve_score_backend(score_backend, device)
    if builders is None:
        builders = make_builders()
    _require_sweep_for_seed(seed_layers, sweep)
    profile = objective_profile(profile, objective)
    stats = TuneStats()
    t0 = time.perf_counter()
    if sweep:
        engine = SweepEngine(builders, profile, stats,
                             score_backend=score_backend,
                             layer_cache=layer_cache, device=device)
        if seed_layers:
            engine.seed(D, seed_layers)
        layers, names, cost = _airtune_rec_sweep(D, profile, engine, k,
                                                 max_layers, stats)
    else:
        layers, names, cost = _airtune_rec(D, profile, builders, k,
                                           max_layers, stats)
    stats.wall_seconds = time.perf_counter() - t0
    design = IndexDesign(layers=tuple(layers), data=D)
    # the recursion's incremental cost must agree with the Eq. (6) evaluator
    return TuneResult(design=design, cost=cost, stats=stats,
                      strategy="airtune", builder_names=tuple(names),
                      objective=_objective_field(objective))


def _airtune_rec_sweep(D: KeyPositions, profile: StorageProfile,
                       engine: SweepEngine, k: int, depth_left: int,
                       stats: TuneStats) -> tuple[list, list, float]:
    stats.vertices_visited += 1
    no_index_cost = float(profile(D.size_bytes))   # L_SM(D; (), T)

    # stopping criterion: even an ideal layer cannot beat reading D outright
    if no_index_cost < ideal_latency_with_index(profile) or depth_left == 0 \
            or D.n <= 1:
        return [], [], no_index_cost

    # one fused sweep builds + scores every outgoing edge (§5.2/§5.3);
    # ranking uses sampled estimates, the k selected candidates are
    # re-scored exactly, so the returned cost is still exactly Eq. (6)
    candidates = engine.children(D)
    ranked = sorted(candidates, key=lambda c: c.score)  # stable: ties keep
    #                                                     builder order
    stats.candidates_pruned += max(len(ranked) - k, 0)
    top = ranked[:k]
    exact = engine.exact_read_costs(D, top) if top else []
    best_layers, best_names, best_cost = [], [], no_index_cost
    for cand, read_cost in zip(top, exact):
        upper_layers, upper_names, upper_cost = _airtune_rec_sweep(
            cand.outline, profile, engine, k, depth_left - 1, stats)
        total = read_cost + upper_cost       # V(D) recursion (Alg. 2 line 11)
        if total < best_cost:
            best_cost = total
            best_layers = [cand.layer] + upper_layers
            best_names = [cand.name] + upper_names
    return best_layers, best_names, best_cost


def _airtune_rec(D: KeyPositions, profile: StorageProfile,
                 builders: list[LayerBuilder], k: int, depth_left: int,
                 stats: TuneStats) -> tuple[list, list, float]:
    """Legacy per-builder loop (``sweep=False``) — the sweep engine's
    bit-identical reference; kept as the escape hatch and the baseline
    the tuning benchmark measures reductions against."""
    stats.vertices_visited += 1
    no_index_cost = float(profile(D.size_bytes))   # L_SM(D; (), T)

    if no_index_cost < ideal_latency_with_index(profile) or depth_left == 0 \
            or D.n <= 1:
        return [], [], no_index_cost

    candidates = []
    for F in builders:
        layer = F(D)
        stats.layers_built += 1
        D_next = outline(layer, D)
        # safeguard: only strictly shrinking layers guarantee termination
        if D_next.size_bytes >= D.size_bytes:
            stats.candidates_pruned += 1
            continue
        est_cost = _mean_layer_read_cost(layer, D, profile, sample=True)
        stats.candidates_scored += 1
        score = tau_hat(D_next, profile) + est_cost         # Eq. (9)
        candidates.append((score, F.name, layer, D_next))

    # select top-k by index-complexity-guided score (§5.3)
    candidates.sort(key=lambda c: c[0])
    stats.candidates_pruned += max(len(candidates) - k, 0)
    best_layers, best_names, best_cost = [], [], no_index_cost
    for score, fname, layer, D_next in candidates[:k]:
        read_cost = _mean_layer_read_cost(layer, D, profile)   # exact
        stats.candidates_scored += 1
        upper_layers, upper_names, upper_cost = _airtune_rec(
            D_next, profile, builders, k, depth_left - 1, stats)
        total = read_cost + upper_cost       # V(D) recursion (Alg. 2 line 11)
        if total < best_cost:
            best_cost = total
            best_layers = [layer] + upper_layers
            best_names = [fname] + upper_names
    return best_layers, best_names, best_cost


@register_strategy("brute_force")
def brute_force(D: KeyPositions, profile: StorageProfile,
                builders: list[LayerBuilder] | None = None, *,
                k: int = 0, max_layers: int = 4, sweep: bool = True,
                score_backend: str = "cuda",
                layer_cache: LayerCache | None = None,
                seed_layers=None, objective=None, device=None) -> TuneResult:
    """Exhaustive reference search (no top-k pruning, no τ̂ guidance).

    Exponential in |𝓕|; only usable on small inputs.  Tests use it to
    certify AirTune's pruning never loses the optimum on tractable cases.
    ``k`` is accepted for :class:`SearchStrategy` compatibility and
    ignored — brute force never prunes by score; its
    ``candidates_pruned`` counts only edges discarded by the
    strictly-shrinking termination safeguard.  The sweep engine's vertex
    memoization pays off most here: exhaustive recursion re-reaches
    identical collections constantly.
    """
    score_backend, device = resolve_score_backend(score_backend, device)
    if builders is None:
        builders = make_builders()
    _require_sweep_for_seed(seed_layers, sweep)
    profile = objective_profile(profile, objective)
    stats = TuneStats()
    t0 = time.perf_counter()
    # rank_scores=False: brute force never ranks by Eq. (9), so the sweep
    # skips the sampled Ê[T(Δ)]/τ̂ pass entirely
    engine = SweepEngine(builders, profile, stats, score_backend=score_backend,
                         rank_scores=False, layer_cache=layer_cache,
                         device=device) if sweep else None
    if seed_layers:
        engine.seed(D, seed_layers)    # warm start: pure memoization

    def rec_sweep(Dc: KeyPositions, depth_left: int) -> tuple[list, list, float]:
        stats.vertices_visited += 1
        best_layers, best_names = [], []
        best_cost = float(profile(Dc.size_bytes))
        if depth_left == 0 or Dc.n <= 1:
            return best_layers, best_names, best_cost
        cands = engine.children(Dc)
        exact = engine.exact_read_costs(Dc, cands) if cands else []
        for cand, read_cost in zip(cands, exact):
            upper_layers, upper_names, upper_cost = rec_sweep(
                cand.outline, depth_left - 1)
            total = read_cost + upper_cost
            if total < best_cost:
                best_cost = total
                best_layers = [cand.layer] + upper_layers
                best_names = [cand.name] + upper_names
        return best_layers, best_names, best_cost

    def rec(Dc: KeyPositions, depth_left: int) -> tuple[list, list, float]:
        stats.vertices_visited += 1
        best_layers, best_names = [], []
        best_cost = float(profile(Dc.size_bytes))
        if depth_left == 0 or Dc.n <= 1:
            return best_layers, best_names, best_cost
        for F in builders:
            layer = F(Dc)
            stats.layers_built += 1
            D_next = outline(layer, Dc)
            if D_next.size_bytes >= Dc.size_bytes:
                stats.candidates_pruned += 1
                continue
            upper_layers, upper_names, upper_cost = rec(D_next, depth_left - 1)
            total = _mean_layer_read_cost(layer, Dc, profile) + upper_cost
            stats.candidates_scored += 1
            if total < best_cost:
                best_cost = total
                best_layers = [layer] + upper_layers
                best_names = [F.name] + upper_names
        return best_layers, best_names, best_cost

    layers, names, cost = (rec_sweep if sweep else rec)(D, max_layers)
    stats.wall_seconds = time.perf_counter() - t0
    return TuneResult(design=IndexDesign(layers=tuple(layers), data=D),
                      cost=cost, stats=stats, strategy="brute_force",
                      builder_names=tuple(names),
                      objective=_objective_field(objective))


@register_strategy("beam")
def beam_search(D: KeyPositions, profile: StorageProfile,
                builders: list[LayerBuilder] | None = None, *,
                k: int = 5, max_layers: int = 12, sweep: bool = True,
                score_backend: str = "cuda",
                layer_cache: LayerCache | None = None,
                seed_layers=None, objective=None, device=None) -> TuneResult:
    """Beam search over layer stacks: Alg. 2's graph, breadth-first.

    A frontier of at most ``k`` partial designs (bottom-up layer stacks)
    advances one layer per round; every frontier state expands through all
    of 𝓕 and the ``k`` best children *overall* — scored by accumulated
    exact read cost plus the Eq. 9 score ``τ̂(D_next) + Ê[T(Δ)]`` — survive.
    Shares :func:`airtune`'s stopping criterion, so frontier states whose
    collection is already cheaper to read outright than an ideal extra
    layer stop expanding.  Unlike the depth-first top-k recursion (which
    re-branches inside every selected child), total work is bounded by
    ``max_layers · k · |𝓕|`` layer builds — a predictable budget when the
    registered family set is large.

    With ``k`` at least the number of shrinking children per round the
    beam degenerates to exhaustive breadth-first search and matches
    :func:`brute_force` exactly.
    """
    score_backend, device = resolve_score_backend(score_backend, device)
    if builders is None:
        builders = make_builders()
    _require_sweep_for_seed(seed_layers, sweep)
    profile = objective_profile(profile, objective)
    stats = TuneStats()
    t0 = time.perf_counter()
    engine = SweepEngine(builders, profile, stats,
                         score_backend=score_backend,
                         layer_cache=layer_cache, device=device) if sweep \
        else None
    stats.vertices_visited += 1
    best_cost = float(profile(D.size_bytes))     # stop at the data layer
    best_layers: list = []
    best_names: list = []
    ideal = ideal_latency_with_index(profile)
    # frontier state: (exact cost of layers so far, collection, layers, names)
    frontier = [(0.0, D, [], [])]
    if seed_layers:
        # warm start: besides memoizing the old builds (engine.seed), the
        # previous design's partial stacks enter the beam as initial
        # vertices — the frontier starts where the last search ended, and
        # the seed's complete Eq. (6) cost bounds `best` from the first
        # round (the search can only match or improve on the old design)
        acc = 0.0
        cur_layers: list = []
        cur_names: list = []
        for name, layer, Dc, out in engine.seed(D, seed_layers)[:max_layers]:
            acc += _mean_layer_read_cost(layer, Dc, profile)   # exact
            stats.candidates_scored += 1
            cur_layers = cur_layers + [layer]
            cur_names = cur_names + [name]
            stats.vertices_visited += 1
            complete = acc + float(profile(out.size_bytes))    # Eq. (6)
            if complete < best_cost:
                best_cost = complete
                best_layers, best_names = cur_layers, cur_names
            frontier.append((acc, out, cur_layers, cur_names))
    for _ in range(max_layers):
        children = []
        for cost_so_far, Dc, layers, names in frontier:
            # stopping criterion, per state (Alg. 2 lines 1–2); the depth
            # bound re-checked per state because warm-start-injected seed
            # stacks enter the frontier at arbitrary depth
            if float(profile(Dc.size_bytes)) < ideal or Dc.n <= 1 \
                    or len(layers) >= max_layers:
                continue
            if sweep:
                for cand in engine.children(Dc):
                    score = cost_so_far + cand.est_cost + cand.tau  # Eq. (9)
                    children.append((score, cost_so_far, Dc, cand.layer,
                                     cand.name, cand.outline, layers, names,
                                     cand))
                continue
            for F in builders:
                layer = F(Dc)
                stats.layers_built += 1
                D_next = outline(layer, Dc)
                if D_next.size_bytes >= Dc.size_bytes:
                    stats.candidates_pruned += 1
                    continue
                est = _mean_layer_read_cost(layer, Dc, profile, sample=True)
                stats.candidates_scored += 1
                score = cost_so_far + est + tau_hat(D_next, profile)  # Eq. (9)
                children.append((score, cost_so_far, Dc, layer, F.name,
                                 D_next, layers, names, None))
        if not children:
            break
        children.sort(key=lambda c: c[0])
        stats.candidates_pruned += max(len(children) - k, 0)
        frontier = []
        for (score, cost_so_far, Dc, layer, fname, D_next,
             layers, names, cand) in children[:k]:
            if cand is not None:
                read_cost = engine.exact_read_costs(Dc, [cand])[0]
            else:
                read_cost = _mean_layer_read_cost(layer, Dc, profile)  # exact
                stats.candidates_scored += 1
            new_cost = cost_so_far + read_cost
            new_layers = layers + [layer]
            new_names = names + [fname]
            stats.vertices_visited += 1
            complete = new_cost + float(profile(D_next.size_bytes))  # Eq. (6)
            if complete < best_cost:
                best_cost = complete
                best_layers, best_names = new_layers, new_names
            frontier.append((new_cost, D_next, new_layers, new_names))
    stats.wall_seconds = time.perf_counter() - t0
    design = IndexDesign(layers=tuple(best_layers), data=D)
    assert abs(expected_latency(design, profile) - best_cost) \
        <= 1e-9 * max(best_cost, 1e-30)
    return TuneResult(design=design, cost=best_cost, stats=stats,
                      strategy="beam", builder_names=tuple(best_names),
                      objective=_objective_field(objective))
