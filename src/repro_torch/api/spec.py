"""Declarative tuning and serving specifications — the "how", as data.

A :class:`TuneSpec` names everything Alg. 2 needs beyond the data and the
storage profile: the competing builder families, their λ-grid, the search
strategy and its knobs, and the serving-side layout/cache defaults.  A
:class:`ServeSpec` names everything the batched engine
(:class:`repro_torch.serve.IndexService`) needs beyond (file, deployment
tier): cache tiers, residency, descent backend, the two-stage pipeline
knobs and the :class:`RetryPolicy`.  All are frozen value objects that
round-trip through JSON; both packages read each other's JSON
(``repro.api.spec`` is the JAX package's), so an index meta written by
either opens in the other.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.builders import (DEFAULT_FAMILIES, LayerBuilder,
                                      make_builders)
from repro_torch.core.registry import BUILDER_FAMILIES, SEARCH_STRATEGIES
from repro_torch.core.storage import PROFILES, normalize_objective
from repro_torch.kernels._cuda import REFERENCE_BACKENDS

#: resident-prefix descent backends: the fused kernel on the service's
#: device, or the bit-exact float64 walk
SERVE_BACKENDS = ("cuda", "numpy")
#: the name a written meta gives the port's backend, so that the JAX
#: package (whose ``ServeSpec.validate`` knows only its own names) can serve
#: the file: its fused device descent
_WRITTEN_BACKENDS = {"cuda": "pallas"}


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """Everything needed to (re)produce a tuned index from (data, profile).

    Fields
    ------
    families:    builder-family names resolved through the registry; any
                 family registered via
                 ``repro_torch.core.register_builder`` participates in
                 the search.  Besides the paper's deployed set
                 (``gstep``/``gband``/``eband``), the baseline families
                 ``btree``/``rmi_leaf``/``pgm``
                 (:data:`repro_torch.core.baselines.BASELINE_FAMILIES`)
                 are registered and can be mixed in freely — e.g.
                 ``families=("btree", "pgm", "gstep")``.
    lam_low/lam_high/lam_base: the Eq. (8) granularity grid
                 ``λ_low · lam_base^j ≤ λ_high``.
    p:           pieces per step node (gstep-family parameter).
    k:           search width (top-k selection / beam width).
    max_layers:  index depth bound.
    strategy:    search-strategy name resolved through the registry
                 (``airtune`` | ``brute_force`` | ``beam`` | registered).
    page_bytes:  on-disk layout page size of the written file (0 =
                 densely packed; >0 = paged, the serving cache unit).
    cache_bytes: default tiered-cache capacities (hottest first) that
                 ``IndexService`` uses when the caller does not override
                 them; () = engine default.
    objective:   what the search minimizes — ``"mean"`` (Eq. 6 expected
                 lookup latency; the default, bit-identical to the
                 pre-objective search) or ``{"p": q, "weight": w}`` for
                 the tail objective ``E[T] + w·Q̂_p[T]`` (see
                 :class:`repro_torch.core.storage.ObjectiveProfile` for
                 the quantile propagation).  Recorded in the on-disk meta;
                 metas written before this field simply omit it and
                 parse as ``"mean"``.
    """

    families: tuple = DEFAULT_FAMILIES
    lam_low: float = 2.0**8
    lam_high: float = 2.0**20
    lam_base: float = 2.0
    p: int = 16
    k: int = 5
    max_layers: int = 12
    strategy: str = "airtune"
    page_bytes: int = 0
    cache_bytes: tuple = ()
    objective: object = "mean"

    def __post_init__(self):
        object.__setattr__(self, "families", tuple(self.families))
        object.__setattr__(self, "cache_bytes",
                           tuple(int(c) for c in self.cache_bytes))

    # -- validation ---------------------------------------------------------
    def validate(self) -> "TuneSpec":
        """Resolve all registry names (KeyError lists what is registered)
        and sanity-check the numeric knobs.  Returns self for chaining."""
        for fam in self.families:
            BUILDER_FAMILIES.get(fam)
        SEARCH_STRATEGIES.get(self.strategy)
        # real raises, not asserts: user input must stay checked under -O
        if not self.families:
            raise ValueError("at least one builder family required")
        if not (self.lam_base > 1.0 and 0 < self.lam_low <= self.lam_high):
            raise ValueError(
                f"bad λ grid: need lam_base > 1 and 0 < lam_low <= lam_high, "
                f"got base={self.lam_base} low={self.lam_low} "
                f"high={self.lam_high}")
        if self.p < 1 or self.k < 1 or self.max_layers < 0:
            raise ValueError(f"bad knobs: p={self.p} k={self.k} "
                             f"max_layers={self.max_layers}")
        if self.page_bytes < 0 or any(c < 0 for c in self.cache_bytes):
            raise ValueError(f"negative sizes: page_bytes={self.page_bytes} "
                             f"cache_bytes={self.cache_bytes}")
        normalize_objective(self.objective)   # ValueError on bad objectives
        return self

    # -- materialization ----------------------------------------------------
    def builders(self) -> list[LayerBuilder]:
        """Instantiate the candidate set 𝓕 on the Eq. (8) grid."""
        return make_builders(lam_low=self.lam_low, lam_high=self.lam_high,
                             base=self.lam_base, p=self.p, kinds=self.families)

    def replace(self, **changes) -> "TuneSpec":
        return dataclasses.replace(self, **changes)

    # -- JSON round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["families"] = list(self.families)
        d["cache_bytes"] = list(self.cache_bytes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuneSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown TuneSpec fields {sorted(unknown)}; "
                f"allowed: {sorted(known)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TuneSpec":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the serving engine survives a flaky storage tier.

    Every pread gets up to ``max_attempts`` tries; a failed attempt
    (``OSError``, short read, or a read slower than ``pread_deadline_s``)
    sleeps ``backoff_s · backoff_mult^attempt`` (capped at
    ``max_backoff_s``) before the next.  A coalesced multi-page run that
    exhausts its budget is split and retried at page granularity before
    the engine gives up with a typed :class:`repro_torch.serve.ReadError`.
    ``batch_deadline_s`` bounds one whole ``lookup`` call.  Deadlines
    default to None (unbounded).
    """

    max_attempts: int = 3
    backoff_s: float = 0.001
    backoff_mult: float = 2.0
    max_backoff_s: float = 0.1
    pread_deadline_s: float | None = None
    batch_deadline_s: float | None = None

    def validate(self) -> "RetryPolicy":
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.backoff_s < 0 or self.max_backoff_s < 0 \
                or self.backoff_mult < 1.0:
            raise ValueError(
                f"bad backoff: backoff_s={self.backoff_s} "
                f"backoff_mult={self.backoff_mult} "
                f"max_backoff_s={self.max_backoff_s}")
        for name in ("pread_deadline_s", "batch_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive or None, got {v}")
        return self

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (0-based failed attempt)."""
        return min(self.backoff_s * self.backoff_mult ** attempt,
                   self.max_backoff_s)

    def replace(self, **changes) -> "RetryPolicy":
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RetryPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown RetryPolicy fields {sorted(unknown)}; "
                f"allowed: {sorted(known)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RetryPolicy":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Everything the serving engine needs beyond (file, deployment tier).

    Fields
    ------
    cache_bytes:     tiered block-cache capacities, hottest first;
                     ``()`` falls back to the TuneSpec-recorded capacities
                     in the file meta, else a single 1 MiB tier.
    cache_profile:   ``PROFILES`` name the cache's hit cost is modeled on
                     (None: hits are free in ``modeled_seconds``).
    page_bytes:      cache unit; 0 = the file's paged layout, else 4096.
    resident_layers: top layers pinned in memory at open (at least the
                     root, per Alg. 1).
    backend:         resident-prefix descent backend — ``"cuda"`` runs the
                     fused descent on the service's device (the hand-written
                     kernel on a card; its plain PyTorch version on the CPU,
                     which is for tests), ``"numpy"`` the bit-exact float64
                     walk.  ``"pallas"`` and ``"jnp"`` from a JAX-written
                     meta read as ``"cuda"``, and ``to_dict`` writes
                     ``"cuda"`` as ``"pallas"``, the JAX package's name for
                     its fused device descent.
    interpret:       kept so that JAX-written metas round-trip; ignored.
    coalesce_gap:    merge missing-page runs separated by ≤ this many bytes.
    persist_stats:   write each epoch's ServeStats snapshot next to the
                     index (``<path>.stats.json``) on close and on swap.
    pipeline_depth:  batches prefetched ahead by ``lookup_batches``'s
                     background stage (0 = unpipelined serving).
    prefetch_layers: disk layers the prefetch stage walks ahead per
                     future batch (first-window preads only, no gallop).
    retry:           :class:`RetryPolicy` for every pread the engine issues
                     (a JSON dict coerces on construction).
    verify_checksums: verify the per-page CRC32 table of the paged layout
                     on every cache fill (corrupt pages are refetched once,
                     then raise :class:`repro_torch.serve.CorruptPageError`).
    """

    cache_bytes: tuple = ()
    cache_profile: str | None = "host_dram"
    page_bytes: int = 0
    resident_layers: int = 1
    backend: str = "cuda"
    interpret: bool = True
    coalesce_gap: int = 0
    persist_stats: bool = False
    pipeline_depth: int = 0
    prefetch_layers: int = 1
    retry: RetryPolicy = RetryPolicy()
    verify_checksums: bool = True

    def __post_init__(self):
        object.__setattr__(self, "cache_bytes",
                           tuple(int(c) for c in self.cache_bytes))
        object.__setattr__(self, "backend",
                           REFERENCE_BACKENDS.get(self.backend, self.backend))
        if isinstance(self.retry, dict):   # JSON round-trip / replace(dict)
            object.__setattr__(self, "retry",
                               RetryPolicy.from_dict(self.retry))

    def validate(self) -> "ServeSpec":
        """Sanity-check knobs and resolve the cache-profile name.  Returns
        self for chaining; real raises (user input stays checked under -O).
        """
        if self.backend not in SERVE_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"one of {SERVE_BACKENDS}")
        if self.cache_profile is not None \
                and self.cache_profile not in PROFILES:
            raise ValueError(
                f"unknown cache_profile {self.cache_profile!r}; named "
                f"profiles: {', '.join(sorted(PROFILES))}")
        if self.page_bytes < 0 or any(c < 0 for c in self.cache_bytes):
            raise ValueError(f"negative sizes: page_bytes={self.page_bytes} "
                             f"cache_bytes={self.cache_bytes}")
        if self.resident_layers < 0 or self.pipeline_depth < 0 \
                or self.coalesce_gap < 0 or self.prefetch_layers < 1:
            raise ValueError(
                f"bad knobs: resident_layers={self.resident_layers} "
                f"pipeline_depth={self.pipeline_depth} "
                f"coalesce_gap={self.coalesce_gap} "
                f"prefetch_layers={self.prefetch_layers}")
        if not isinstance(self.retry, RetryPolicy):
            raise ValueError(f"retry must be a RetryPolicy (or its dict "
                             f"form), got {type(self.retry).__name__}")
        self.retry.validate()
        return self

    def replace(self, **changes) -> "ServeSpec":
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cache_bytes"] = list(self.cache_bytes)
        d["backend"] = _WRITTEN_BACKENDS.get(self.backend, self.backend)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown ServeSpec fields {sorted(unknown)}; "
                f"allowed: {sorted(known)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ServeSpec":
        return cls.from_dict(json.loads(s))
