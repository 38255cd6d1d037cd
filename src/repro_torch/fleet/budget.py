"""Global cache-byte budgeting across a fleet of shards (§6 applied
fleet-wide): allocate one memory budget over N per-shard block caches by
marginal E[T(Δ)] gain.

Each shard's Eq. 6 cost as a function of its cache bytes ``c`` is — under
the engine's LRU with a stable working set ``w`` and the linear hit model
``h(c) = min(1, c/w)`` — piecewise linear and concave::

    cost_i(c) = base_i + saving_i · (1 − h(c))
              = base_i + saving_i · max(0, 1 − c/w_i)

so the *marginal* gain of one more byte given to shard ``i`` is the
constant ``traffic_i · saving_i / w_i`` until the working set fits, then
zero.  Greedy water-filling over such curves is exactly optimal: sort
shards by marginal-gain density and saturate working sets in that order.
``saving_i`` is the per-query Eq. 6 spend a full cache removes (the
backing-tier cost of every non-resident layer read, minus the cache
tier's hit cost), ``w_i`` the shard's cacheable working set (serialized
bytes of its non-resident layers), and ``traffic_i`` the shard's observed
query share — recomputed from persisted per-shard ServeStats so hot
shards earn more cache (see :meth:`repro_torch.fleet.Fleet.serve`).

Host code over numpy, as the JAX package's ``repro.fleet.budget``: the
same demands give the same plan, allocations and predicted gain.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.storage import StorageProfile
from repro_torch.serve.index_service import cacheable_working_set

DEFAULT_QUANTUM = 4096


@dataclasses.dataclass(frozen=True)
class ShardDemand:
    """One shard's cost-vs-cache-bytes curve, reduced to its three
    sufficient statistics (the curve is linear until saturation)."""

    shard: int
    traffic: float      # observed query share (any nonnegative scale)
    working_set: int    # cacheable bytes: serialized non-resident layers
    saving: float       # per-query E[T] seconds a full cache removes

    @property
    def density(self) -> float:
        """Marginal gain of one cached byte: traffic · saving / w
        (seconds removed per byte, before saturation)."""
        if self.working_set <= 0 or self.saving <= 0 or self.traffic <= 0:
            return 0.0
        return self.traffic * self.saving / float(self.working_set)

    def gain(self, alloc_bytes: int) -> float:
        """Traffic-weighted seconds removed by an ``alloc_bytes`` cache
        (the linear hit model's prediction, saturating at w)."""
        if self.working_set <= 0:
            return 0.0
        h = min(1.0, alloc_bytes / float(self.working_set))
        return self.traffic * self.saving * h

    def to_dict(self) -> dict:
        return {"shard": self.shard, "traffic": self.traffic,
                "working_set": self.working_set, "saving": self.saving,
                "density": self.density}


def _resident_split(layers, resident_layers: int):
    """Non-resident slice of a bottom-up layer tuple, mirroring the
    engine's pinning rule (top ``n_res`` layers resident, root always)."""
    L = len(layers)
    n_res = min(max(int(resident_layers), 1), L) if L else 0
    return layers[:L - n_res]


def demand_from_design(shard: int, design, backing: StorageProfile, *,
                       cache: StorageProfile | None = None,
                       resident_layers: int = 1, traffic: float = 1.0,
                       working_set: int | None = None) -> ShardDemand:
    """Exact Eq. 6 saving for an in-memory design: the weighted-mean
    backing cost of every non-resident layer's prediction windows, minus
    the cache tier's hit cost for the same windows — what the block cache
    removes per query once the working set is resident.  ``working_set``
    defaults to the layers' serialized sizes (pass the file meta's exact
    figure when the fleet is already on disk)."""
    cacheable = _resident_split(design.layers, resident_layers)
    if working_set is None:
        working_set = int(sum(l.size_bytes for l in cacheable))
    saving = 0.0
    D = design.data
    for layer in cacheable:
        wq = layer.widths_at(D.keys)
        full = float(np.average(backing(wq), weights=D.weights))
        hit = float(np.average(cache(wq), weights=D.weights)) \
            if cache is not None else 0.0
        saving += max(full - hit, 0.0)
    return ShardDemand(shard=int(shard), traffic=float(traffic),
                       working_set=int(working_set), saving=saving)


def demand_from_meta(shard: int, meta, backing: StorageProfile, *,
                     cache: StorageProfile | None = None,
                     resident_layers: int = 1,
                     traffic: float = 1.0) -> ShardDemand:
    """Demand for a disk-opened shard whose design cannot be materialized
    (no data layer): the working set is exact (layer sizes from the file
    meta); the per-layer window cost is approximated by one page-sized
    read per non-resident layer — the right order for tuned designs,
    whose windows land near the layout page."""
    cacheable = _resident_split(meta.layers, resident_layers)
    working_set = cacheable_working_set(meta, resident_layers)
    win = float(meta.page_bytes or DEFAULT_QUANTUM)
    per_read = float(backing(win)) - (float(cache(win))
                                      if cache is not None else 0.0)
    saving = max(per_read, 0.0) * len(cacheable)
    return ShardDemand(shard=int(shard), traffic=float(traffic),
                       working_set=int(working_set), saving=saving)


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """The allocator's output: per-shard cache bytes plus the evidence
    (demands, predicted gains)."""

    total_bytes: int
    quantum: int
    shares: tuple         # ((shard, bytes), ...) in shard order
    demands: tuple        # the ShardDemand inputs, in shard order

    def for_shard(self, shard: int) -> int:
        for s, b in self.shares:
            if s == shard:
                return b
        return 0

    @property
    def allocated_bytes(self) -> int:
        return int(sum(b for _, b in self.shares))

    @property
    def unallocated_bytes(self) -> int:
        return self.total_bytes - self.allocated_bytes

    @property
    def predicted_gain(self) -> float:
        """Traffic-weighted seconds removed per unit traffic-time — the
        water-filling objective value at this allocation."""
        by_shard = {d.shard: d for d in self.demands}
        return float(sum(by_shard[s].gain(b) for s, b in self.shares
                         if s in by_shard))

    def to_dict(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "quantum": self.quantum,
            "shares": {str(s): b for s, b in self.shares},
            "unallocated_bytes": self.unallocated_bytes,
            "predicted_gain": self.predicted_gain,
            "demands": [d.to_dict() for d in self.demands],
        }


def allocate_cache_budget(demands, total_bytes: int, *,
                          quantum: int = DEFAULT_QUANTUM) -> CachePlan:
    """Greedy water-filling: saturate working sets in marginal-gain-density
    order until the budget runs out.  Optimal for the piecewise-linear
    concave per-shard curves (each shard's marginal gain is constant until
    its working set fits, then zero), so no fractional refinement is
    needed — allocations are rounded to whole ``quantum`` units (the cache
    page size) and never exceed a shard's working set plus one quantum.

    Budget left over once every working set fits stays unallocated (the
    linear model prices extra bytes at zero marginal gain); callers can
    fold it back as slack if they prefer."""
    demands = sorted(demands, key=lambda d: d.shard)
    if len({d.shard for d in demands}) != len(demands):
        raise ValueError("duplicate shard ids in demands")
    total = max(int(total_bytes), 0)
    q = max(int(quantum), 1)
    alloc = {d.shard: 0 for d in demands}
    remaining = total
    # density desc; ties broken toward hotter, then lower-id shards so the
    # plan is deterministic for identical demands
    order = sorted(demands, key=lambda d: (-d.density, -d.traffic, d.shard))
    for d in order:
        if remaining < q or d.density <= 0:
            continue
        want = -(-d.working_set // q) * q        # round w up to whole pages
        give = min(want, (remaining // q) * q)
        alloc[d.shard] = give
        remaining -= give
    return CachePlan(total_bytes=total, quantum=q,
                     shares=tuple((d.shard, alloc[d.shard])
                                  for d in demands),
                     demands=tuple(demands))


def split_cache_tiers(alloc_bytes: int, template, *,
                      quantum: int = DEFAULT_QUANTUM) -> tuple:
    """Split one shard's allocation across the ServeSpec template's cache
    tiers, preserving the template's proportions (rounded to whole
    quanta, remainder to the hottest tier).  An empty template — engine
    default — becomes a single tier of the full allocation."""
    alloc = max(int(alloc_bytes), 0)
    tiers = tuple(int(t) for t in (template or ()))
    if not tiers or sum(tiers) <= 0:
        return (alloc,)
    q = max(int(quantum), 1)
    total = float(sum(tiers))
    out = [(int(alloc * t / total) // q) * q for t in tiers]
    out[0] += alloc - sum(out)
    return tuple(out)
