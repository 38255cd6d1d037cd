"""``repro_torch.fleet`` — sharded multi-tenant serving: past one
``IndexService`` per process.

A fleet is N key-range shards, each its own on-disk index file with its
own Alg. 2 search, served through scatter-gather with one *global*
cache-byte budget allocated across shards by marginal E[T(Δ)] gain::

    from repro_torch.fleet import Fleet, FleetSpec

    fleet = Fleet.tune(D, "azure_ssd",
                       FleetSpec(n_shards=4, cache_budget_bytes=2 << 20))
    fleet.save("fleet_dir/")
    with Fleet.open("fleet_dir/").serve() as svc:
        ranges = svc.lookup(keys)          # global byte ranges

See :mod:`repro_torch.fleet.fleet` (facade), :mod:`repro_torch.fleet.spec`
(ShardMap/FleetSpec), :mod:`repro_torch.fleet.service` (scatter-gather),
and :mod:`repro_torch.fleet.budget` (water-filling allocator).
"""
# the facade's package first: it re-exports this package's names from the
# submodules below, so its own modules must be loaded before they are
import repro_torch.api  # noqa: F401

from .budget import (CachePlan, ShardDemand, allocate_cache_budget,
                     demand_from_design, demand_from_meta, split_cache_tiers)
from .fleet import Fleet
from .service import FleetService, ShardUnavailableError
from .spec import FleetSpec, ShardMap

__all__ = [
    "Fleet", "FleetSpec", "FleetService", "ShardMap",
    "ShardUnavailableError",
    "CachePlan", "ShardDemand", "allocate_cache_budget",
    "demand_from_design", "demand_from_meta", "split_cache_tiers",
]
