"""Fleet-level declarative configuration: how a keyed collection is
sharded, tuned, served, and cache-budgeted across N index files.

A :class:`ShardMap` is the key-range partition itself — ``n − 1`` split
keys dividing the uint64 key space into contiguous ranges, one per shard.
A :class:`FleetSpec` carries everything else: the per-shard
:class:`~repro_torch.api.spec.TuneSpec` (each shard runs its OWN Alg. 2
search), the per-shard :class:`~repro_torch.api.spec.ServeSpec`, and the
*global* cache-byte budget that :mod:`repro_torch.fleet.budget` allocates
across shards by marginal E[T(Δ)] gain.  Both are frozen value objects
that round-trip through JSON losslessly, so ``Fleet.save`` can persist
them into the fleet manifest (``fleet.json``) next to the shard metas and
``Fleet.open`` restores them.

The nested ServeSpec keeps the port's backend names: ``"cuda"`` is
written as the JAX package's ``"pallas"``, and ``"pallas"`` or ``"jnp"``
read back as ``"cuda"``, so a manifest written by either package opens in
the other.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.api.spec import ServeSpec, TuneSpec
from repro_torch.core.keyset import KEY_DTYPE


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Key-range partition of the uint64 key space into contiguous shards.

    ``bounds`` holds ``n_shards − 1`` strictly increasing split keys;
    shard ``i`` owns ``[bounds[i−1], bounds[i])`` with open outer ends
    (shard 0 owns everything below ``bounds[0]``, the last shard
    everything from ``bounds[-1]`` up).  Routing is one vectorized
    ``searchsorted`` — O(q log n) with no per-key Python.
    """

    bounds: tuple    # (n_shards − 1,) strictly increasing uint64 split keys

    def __post_init__(self):
        b = tuple(int(x) for x in self.bounds)
        if any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"shard bounds must strictly increase: {b}")
        object.__setattr__(self, "bounds", b)

    @property
    def n_shards(self) -> int:
        return len(self.bounds) + 1

    @classmethod
    def even_keys(cls, keys: np.ndarray, n_shards: int) -> "ShardMap":
        """Split sorted unique keys into ``n_shards`` near-equal-count
        ranges; split key ``i`` is the first key of shard ``i``."""
        keys = np.asarray(keys, dtype=KEY_DTYPE)
        n = len(keys)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n < n_shards:
            raise ValueError(f"cannot split {n} keys into {n_shards} shards")
        cuts = [(i * n) // n_shards for i in range(1, n_shards)]
        return cls(bounds=tuple(int(keys[c]) for c in cuts))

    def route(self, keys) -> np.ndarray:
        """→ (q,) int64 shard id per key."""
        q = np.atleast_1d(np.asarray(keys, dtype=KEY_DTYPE))
        b = np.asarray(self.bounds, dtype=KEY_DTYPE)
        return np.searchsorted(b, q, side="right").astype(np.int64)

    def sub_batches(self, keys) -> list:
        """Scatter one query batch → ``[(shard_id, positions), ...]`` for
        every shard that received at least one key, in shard order.
        ``positions`` indexes into the input batch (the gather side puts
        per-shard results back in input order)."""
        sid = self.route(keys)
        return [(int(s), np.flatnonzero(sid == s)) for s in np.unique(sid)]

    def slice_bounds(self, keys: np.ndarray) -> list:
        """Per-shard ``(start, stop)`` index ranges into a sorted key
        array — the partition a :class:`~repro_torch.core.KeyPositions` is
        sliced by when (re)building per-shard collections."""
        keys = np.asarray(keys, dtype=KEY_DTYPE)
        b = np.asarray(self.bounds, dtype=KEY_DTYPE)
        cuts = [0] + list(np.searchsorted(keys, b, side="left")) + [len(keys)]
        return [(int(a), int(z)) for a, z in zip(cuts, cuts[1:])]

    # -- JSON round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds)}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        unknown = set(d) - {"bounds"}
        if unknown:
            raise ValueError(f"unknown ShardMap fields {sorted(unknown)}; "
                             f"allowed: ['bounds']")
        return cls(bounds=tuple(d["bounds"]))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ShardMap":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Everything needed to (re)produce a tuned fleet from (data, profile).

    Fields
    ------
    n_shards:           key-range shards (each its own on-disk index file
                        with its own Alg. 2 search).
    tune:               per-shard :class:`TuneSpec` — families, λ-grid,
                        strategy, and the tuning ``objective`` ("mean" or
                        a ``{"p": q, "weight": w}`` tail objective, which
                        every shard search and ``Fleet.retune`` /
                        ``retune_budgeted`` honor); every shard searches
                        the same space but against its OWN keys and
                        profile.
    serve:              per-shard :class:`ServeSpec` template; the global
                        budget allocator overrides each shard's
                        ``cache_bytes`` (preserving the template's tier
                        proportions when it names several tiers).
    cache_budget_bytes: global cache-byte budget shared by all shards;
                        0 disables budgeting (every shard serves with the
                        ``serve`` template's own cache configuration).
    budget_quantum:     allocation granularity in bytes; 0 = the tune
                        spec's ``page_bytes`` (else 4096) — the cache's
                        page unit, so allocations are always whole pages.
    """

    n_shards: int = 4
    tune: TuneSpec = TuneSpec()
    serve: ServeSpec = ServeSpec()
    cache_budget_bytes: int = 0
    budget_quantum: int = 0

    # -- validation ---------------------------------------------------------
    def validate(self) -> "FleetSpec":
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.cache_budget_bytes < 0 or self.budget_quantum < 0:
            raise ValueError(
                f"negative sizes: cache_budget_bytes="
                f"{self.cache_budget_bytes} "
                f"budget_quantum={self.budget_quantum}")
        self.tune.validate()
        self.serve.validate()
        return self

    @property
    def quantum(self) -> int:
        """Effective allocation granularity (never 0)."""
        return int(self.budget_quantum or self.tune.page_bytes or 4096)

    def replace(self, **changes) -> "FleetSpec":
        return dataclasses.replace(self, **changes)

    # -- JSON round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "tune": self.tune.to_dict(),
            "serve": self.serve.to_dict(),
            "cache_budget_bytes": self.cache_budget_bytes,
            "budget_quantum": self.budget_quantum,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown FleetSpec fields {sorted(unknown)}; "
                f"allowed: {sorted(known)}")
        kw = dict(d)
        if isinstance(kw.get("tune"), dict):
            kw["tune"] = TuneSpec.from_dict(kw["tune"])
        if isinstance(kw.get("serve"), dict):
            kw["serve"] = ServeSpec.from_dict(kw["serve"])
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FleetSpec":
        return cls.from_dict(json.loads(s))
