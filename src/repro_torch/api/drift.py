"""Drift detection — when the serving reality leaves the tuned-for model.

AirIndex's core claim is that the optimal design is a *function of the
I/O profile* (Eq. 6): the recorded ``tune.cost`` is the expected
per-lookup latency under the profile the index was tuned for.  When the
*observed* per-lookup cost (``ServeStats.query_modeled_seconds``, plus
the measured per-pread latencies and the block-cache hit rate) walks away
from that recording, the design is stale and a retune — ideally a
warm-started one (``Index.retune(..., warm_start=True)``) — pays for
itself.  This module turns that comparison into a small, trendable value
object::

    svc = idx.serve(profile=deployed_tier, persist_stats=True)
    svc.lookup(batch); ...
    report = detect_drift(svc)
    if report.action == "retune":
        idx2 = idx.retune(report.observed_profile, warm_start=True)

``detect_drift_from_file`` runs the same comparison offline from the
persisted ``<path>.stats.json`` snapshots — no live service needed.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.storage import (CachedProfile, PROFILES, StorageProfile,
                                profile_from_dict)
from repro_torch.serve.index_service import (MIN_FIT_SAMPLES, ServeStats,
                                       observed_profile_from_stats,
                                       untainted_read_samples)

#: observed/recorded per-lookup cost ratio beyond which we call drift
DRIFT_RATIO = 1.25
#: queries needed before the verdict is fully confident
MIN_QUERIES = 512


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Observed vs recorded per-lookup cost, with a recommended action.

    Three per-lookup numbers are compared (all E[T] seconds):

      * ``recorded_seconds``  — ``tune.cost`` from the index meta: what
        the design was tuned to deliver on its tuned-for tier;
      * ``predicted_seconds`` — the deployment profile's prediction for
        the same design on the observed traffic
        (``ServeStats.walk_query_seconds``: full-price Alg. 1 walk, no
        cache/residency) — so ``ratio = predicted/recorded`` isolates
        *storage-tier* drift and is robust to cache warm-up state;
      * ``observed_seconds``  — what lookups actually cost through the
        engine (residency + block cache), so ``cache_gain =
        observed/predicted ≤ 1`` quantifies the headroom a retune for
        the observed :class:`CachedProfile` can exploit.

    ``confidence`` grows with the number of observed queries
    (``min(1, queries/min_queries)``); ``action`` is ``"retune"``
    (drifted, enough evidence), ``"observe"`` (not enough queries), or
    ``"none"``.  ``observed_profile`` is the effective ``T(Δ)`` to hand
    to ``Index.retune(..., warm_start=True)``.
    """

    observed_seconds: float          # engine per-lookup E[T] (cache-aware)
    predicted_seconds: float         # full-price walk on the deployed tier
    recorded_seconds: float | None   # tune.cost from the index meta
    ratio: float                     # predicted / recorded (inf if unknown)
    cache_gain: float                # observed / predicted (≤ 1 typically)
    confidence: float                # 0..1
    queries: int
    hit_rate: float
    drifted: bool
    action: str                      # "none" | "observe" | "retune"
    observed_profile: CachedProfile | None = None
    threshold: float = DRIFT_RATIO
    # online per-lookup latency quantiles (per-query seconds, estimated
    # from the uniform lookup reservoir); None before any lookups.  These
    # are what a p99 SLO actually experiences — the raw material for
    # deciding to retune with a quantile objective.
    observed_p50_seconds: float | None = None
    observed_p99_seconds: float | None = None

    def describe(self) -> str:
        rec = (f"{self.recorded_seconds * 1e6:.1f}us"
               if self.recorded_seconds is not None else "n/a")
        return (f"DriftReport(observed={self.observed_seconds * 1e6:.1f}us, "
                f"predicted={self.predicted_seconds * 1e6:.1f}us, "
                f"recorded={rec}, ratio={self.ratio:.2f}, "
                f"cache_gain={self.cache_gain:.2f}, "
                f"confidence={self.confidence:.2f}, "
                f"hit_rate={self.hit_rate:.3f}, action={self.action})")

    def to_dict(self) -> dict:
        """JSON-safe trend record (benchmarks persist these per PR)."""
        fin = lambda v: v if v is not None and math.isfinite(v) else None  # noqa: E731
        return {
            "observed_us": fin(self.observed_seconds * 1e6),
            "predicted_us": fin(self.predicted_seconds * 1e6),
            "recorded_us": (fin(self.recorded_seconds * 1e6)
                            if self.recorded_seconds is not None else None),
            "ratio": fin(self.ratio),
            "cache_gain": fin(self.cache_gain),
            "confidence": self.confidence,
            "queries": self.queries,
            "hit_rate": self.hit_rate,
            "drifted": self.drifted,
            "action": self.action,
            "threshold": self.threshold,
            "observed_p50_us": (fin(self.observed_p50_seconds * 1e6)
                                if self.observed_p50_seconds is not None
                                else None),
            "observed_p99_us": (fin(self.observed_p99_seconds * 1e6)
                                if self.observed_p99_seconds is not None
                                else None),
        }


def drift_from_stats(stats: ServeStats, recorded_cost: float | None, *,
                     backing: StorageProfile | None = None,
                     cache: StorageProfile | None = None,
                     threshold: float = DRIFT_RATIO,
                     min_queries: int = MIN_QUERIES,
                     measured: bool = True,
                     distributional: bool = False) -> DriftReport:
    """Pure comparison of a :class:`ServeStats` against a recorded cost —
    shared by the live (:func:`detect_drift`) and offline
    (:func:`detect_drift_from_file`) entry points.

    Drift is symmetric: a tier that got *faster* (ratio < 1/threshold)
    is as stale as one that degraded — the optimum moves either way
    (paper Fig. 1: profile moves, design moves).
    """
    observed = stats.query_modeled_seconds
    predicted = stats.walk_query_seconds
    queries = int(stats.queries)
    confidence = min(1.0, queries / float(max(min_queries, 1)))
    # a fault-dominated window: the reservoir is full enough to fit a
    # profile, but (nearly) everything in it is tainted — retried,
    # repaired, or deadline-hit reads.  Nothing trustworthy can be
    # fitted (measured/distributional fits return None), and a drift
    # verdict from such a window would model a flaky tier as a slow
    # one, so the report degrades to a confidence-0 "observe".
    if len(stats.read_samples) >= MIN_FIT_SAMPLES \
            and len(untainted_read_samples(stats)) < MIN_FIT_SAMPLES:
        confidence = 0.0
    if recorded_cost is not None and recorded_cost > 0 \
            and math.isfinite(predicted):
        ratio = predicted / recorded_cost
    else:
        ratio = float("inf")
    cache_gain = (observed / predicted
                  if math.isfinite(observed) and predicted > 0
                  else float("inf"))
    drifted = math.isfinite(ratio) and not (1.0 / threshold <= ratio
                                            <= threshold)
    if not math.isfinite(ratio) or confidence < 1.0:
        action = "observe"
    elif drifted:
        action = "retune"
    else:
        action = "none"
    profile = None
    if backing is not None:
        profile = observed_profile_from_stats(stats, backing, cache,
                                              measured=measured,
                                              distributional=distributional)
    p50 = stats.lookup_quantile(0.5)
    p99 = stats.lookup_quantile(0.99)
    return DriftReport(observed_seconds=float(observed),
                       predicted_seconds=float(predicted),
                       recorded_seconds=(float(recorded_cost)
                                         if recorded_cost is not None
                                         else None),
                       ratio=float(ratio), cache_gain=float(cache_gain),
                       confidence=float(confidence),
                       queries=queries, hit_rate=float(stats.hit_rate),
                       drifted=bool(drifted), action=action,
                       observed_profile=profile, threshold=float(threshold),
                       observed_p50_seconds=p50, observed_p99_seconds=p99)


def detect_drift(service, *, threshold: float = DRIFT_RATIO,
                 min_queries: int = MIN_QUERIES,
                 measured: bool = True,
                 distributional: bool = False) -> DriftReport:
    """Compare a live :class:`repro_torch.serve.IndexService`'s observed E[T]
    against the ``tune.cost`` recorded in its file meta.
    ``distributional=True`` makes the report's ``observed_profile`` carry
    the per-Δ distribution fit — the input a quantile-objective retune
    needs."""
    recorded = (service.tune_meta or {}).get("cost")
    return drift_from_stats(service.stats, recorded,
                            backing=service.profile,
                            cache=service.cache_profile,
                            threshold=threshold, min_queries=min_queries,
                            measured=measured, distributional=distributional)


def detect_drift_from_file(index_path: str, *,
                           backing: StorageProfile | str | None = None,
                           cache: StorageProfile | None = None,
                           threshold: float = DRIFT_RATIO,
                           min_queries: int = MIN_QUERIES,
                           measured: bool = True,
                           distributional: bool = False) -> DriftReport | None:
    """Offline observe→retune: read the persisted ``<path>.stats.json``
    snapshot and the index meta's recorded cost/profile, no service
    required.  ``backing`` defaults to the profile the snapshot was
    *served* under (recorded per snapshot by ``save_stats_snapshot``) —
    the observed_profile must describe the deployment tier, not the
    tuned-for tier the report may be flagging as stale — falling back to
    the meta's tuned-for profile for snapshots without a profile name.
    Returns None when no snapshot has been persisted yet.

    Robust to damage: a corrupt or truncated stats file never raises —
    unreadable snapshots are skipped newest-first (``load_stats_history``
    warns), and a stats file that exists but yields nothing usable
    produces a low-confidence ``action="observe"`` report (empty stats →
    confidence 0) rather than an exception, so a fleet startup reading N
    of these degrades per shard instead of failing."""
    import os
    import warnings

    from repro_torch.core.serialize import read_meta_path
    from repro_torch.serve.index_service import load_stats_history, stats_path

    history = load_stats_history(index_path)
    if not history and not os.path.exists(stats_path(index_path)):
        return None
    stats = used_snap = None
    for snap in reversed(history):
        try:
            stats = ServeStats.from_snapshot(snap["stats"])
            used_snap = snap
            break
        except (KeyError, TypeError, ValueError, IndexError):
            warnings.warn(
                f"stats file {stats_path(index_path)!r}: skipping a "
                f"snapshot that does not decode as ServeStats",
                RuntimeWarning, stacklevel=2)
    if stats is None:
        # file present but nothing loadable: report "keep observing" at
        # zero confidence instead of raising
        warnings.warn(
            f"stats file {stats_path(index_path)!r} holds no usable "
            f"snapshot; returning a low-confidence observe report",
            RuntimeWarning, stacklevel=2)
        stats = ServeStats()
    meta = read_meta_path(index_path)
    tune = meta.tune or {}
    if cache is None:
        # IndexService's default cache tier, so the offline profile
        # compares field-equal to the live service's observed_profile()
        cache = PROFILES["host_dram"]
    if isinstance(backing, str):
        backing = PROFILES[backing]
    if backing is None and used_snap is not None:
        served = used_snap.get("profile")
        if served in PROFILES:
            backing = PROFILES[served]
    if backing is None:
        backing = profile_from_dict(tune.get("profile_params"))
        if backing is None and tune.get("profile") in PROFILES:
            backing = PROFILES[tune["profile"]]
    return drift_from_stats(stats, tune.get("cost"), backing=backing,
                            cache=cache, threshold=threshold,
                            min_queries=min_queries, measured=measured,
                            distributional=distributional)
