"""The :class:`Fleet` facade — N per-shard indexes behind one handle,
mirroring :class:`repro_torch.api.Index`'s tune → disk → serve lifecycle::

    fleet = Fleet.tune(D, "azure_ssd", FleetSpec(n_shards=4,
                                                 cache_budget_bytes=2 << 20))
    fleet.build()                  # per-shard Alg. 2, one shared LayerCache
    fleet.save("fleet_dir/")       # shard_0000.air ... + fleet.json manifest
    svc = Fleet.open("fleet_dir/").serve()   # budgeted FleetService
    ranges = fleet.lookup(keys)    # global byte ranges, any shard

Each shard gets its OWN search (the per-partition specialization of
arXiv 2208.03823): its local key distribution, its own observed
:class:`~repro_torch.core.CachedProfile` on retune.  One
:class:`~repro_torch.core.sweep.LayerCache` is shared across all shard searches
— candidate layers built for one shard's collection are memo hits for
any other shard that reaches an identical collection, and for every
later retune.

Shard files are written *rebased*: each shard's key-position slice is
shifted so its first byte is position 0, and the shift (``base``) is
recorded in the manifest.  This keeps every per-shard file
self-consistent (the engine clamps results to ``[0, data_size]``);
``Fleet.lookup`` / :class:`FleetService` add the base back, so callers
always see the original global byte space.

As with :class:`repro_torch.api.Index`, where the port runs is two
keyword-only arguments of the constructors, ``device`` and
``score_backend``, handed to every shard's ``Index`` (and ``device`` to
the :class:`FleetService` that :meth:`Fleet.serve` opens); they never
enter the manifest or a shard file.  ``None`` keeps the defaults: ranking
and the resident descent on the card.  The files, the manifest, the
designs, costs and cache plans are the JAX package's ``repro.fleet``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.api.index import Index, resolve_profile
from repro_torch.api.spec import ServeSpec
from repro_torch.core.keyset import KeyPositions
from repro_torch.core.storage import (CachedProfile, profile_from_dict,
                                      profile_to_dict)
from repro_torch.core.sweep import DEFAULT_CACHE_ENTRIES, LayerCache
from repro_torch.serve.index_service import (cacheable_working_set,
                                             load_serve_stats,
                                             observed_profile_from_stats)

from .budget import (CachePlan, allocate_cache_budget, demand_from_design,
                     demand_from_meta, split_cache_tiers)
from .spec import FleetSpec, ShardMap
from .service import FleetService

MANIFEST_NAME = "fleet.json"
SHARD_TEMPLATE = "shard_{:04d}.air"

_MISSING = object()


def _rebase(part: KeyPositions) -> tuple[KeyPositions, int]:
    """Shift a key-position slice so its first byte is position 0; the
    returned base is what lookups must add back."""
    if part.n == 0:
        return part, 0
    base = int(part.lo[0])
    if base == 0:
        return part, 0
    return KeyPositions(keys=part.keys, lo=part.lo - base,
                        hi=part.hi - base, weights=part.weights), base


def _partition(data: KeyPositions, shard_map: ShardMap):
    """→ (rebased per-shard collections, per-shard bases)."""
    parts, bases = [], []
    for a, z in shard_map.slice_bounds(data.keys):
        if z <= a:
            raise ValueError(
                "empty shard: the shard map does not match this data "
                "(every shard needs at least one key)")
        part, base = _rebase(data.slice(a, z))
        parts.append(part)
        bases.append(base)
    return parts, bases


class Fleet:
    """Facade over the sharded-fleet lifecycle; construct via
    :meth:`tune` or :meth:`open`."""

    def __init__(self, *, spec: FleetSpec, shard_map: ShardMap, shards,
                 bases, profile=None, profile_name=None, directory=None,
                 device=None, score_backend=None):
        self._spec = spec
        self._shard_map = shard_map
        self._shards: list[Index] = list(shards)
        self._bases = [int(b) for b in bases]
        self._profile = profile
        self._profile_name = profile_name
        self._directory = directory
        # where the port runs: never written to the manifest
        self._device = device
        self._score_backend = score_backend
        # ONE build memo across every shard search and later retune
        self._layer_cache = LayerCache(max_entries=DEFAULT_CACHE_ENTRIES)

    # -- constructors -------------------------------------------------------
    @classmethod
    def tune(cls, data: KeyPositions, profile,
             spec: FleetSpec | None = None, *, device=None,
             score_backend=None, **overrides) -> "Fleet":
        """Declare N per-shard tuning problems: partition ``data`` by key
        range (:meth:`ShardMap.even_keys`), rebase each slice, and set up
        one :class:`repro_torch.api.Index` per shard under ``spec.tune``.
        ``overrides`` are FleetSpec field replacements."""
        spec = spec if spec is not None else FleetSpec()
        if overrides:
            spec = spec.replace(**overrides)
        spec.validate()
        prof, pname = resolve_profile(profile)
        if prof is None:
            raise ValueError("Fleet.tune requires a storage profile")
        shard_map = ShardMap.even_keys(data.keys, spec.n_shards)
        parts, bases = _partition(data, shard_map)
        shards = [Index.tune(part, prof, spec.tune, device=device,
                             score_backend=score_backend) for part in parts]
        return cls(spec=spec, shard_map=shard_map, shards=shards,
                   bases=bases, profile=prof, profile_name=pname,
                   device=device, score_backend=score_backend)

    @classmethod
    def open(cls, directory: str, data: KeyPositions | None = None, *,
             device=None, score_backend=None) -> "Fleet":
        """Open a saved fleet from its manifest (written by either
        package).  Pass ``data`` (the full global collection) to enable
        :meth:`retune` — it is re-partitioned with the *persisted* shard
        map and must reproduce the recorded per-shard bases."""
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            m = json.load(f)
        spec = FleetSpec.from_dict(m["spec"])
        shard_map = ShardMap.from_dict(m["shard_map"])
        prof = profile_from_dict(m.get("profile_params"))
        pname = m.get("profile")
        if prof is None and pname is not None:
            prof, pname = resolve_profile(pname)
        parts = [None] * shard_map.n_shards
        if data is not None:
            parts, bases = _partition(data, shard_map)
            recorded = [int(s["base"]) for s in m["shards"]]
            if bases != recorded:
                raise ValueError(
                    f"data does not match the saved fleet: re-partitioned "
                    f"bases {bases} != recorded {recorded}")
        shards, bases = [], []
        for s, part in zip(m["shards"], parts):
            shards.append(Index.open(os.path.join(directory, s["path"]),
                                     data=part, device=device,
                                     score_backend=score_backend))
            bases.append(int(s["base"]))
        return cls(spec=spec, shard_map=shard_map, shards=shards,
                   bases=bases, profile=prof, profile_name=pname,
                   directory=directory, device=device,
                   score_backend=score_backend)

    # -- lifecycle ----------------------------------------------------------
    def build(self) -> "Fleet":
        """Run every shard's search (idempotent), sharing one LayerCache
        so identical candidate builds across shards/retunes happen once."""
        for idx in self._shards:
            idx._layer_cache = self._layer_cache
            idx.build()
        return self

    def save(self, directory: str) -> "Fleet":
        """Serialize every shard (building first if needed) plus the fleet
        manifest.  Layout::

            directory/
              fleet.json            # spec, shard map, profile, shard table
              shard_0000.air        # per-shard paged index files
              shard_0000.air.stats.json   # per-shard ServeStats (serving)
              ...
        """
        self.build()
        os.makedirs(directory, exist_ok=True)
        table = []
        for i, (idx, base) in enumerate(zip(self._shards, self._bases)):
            name = SHARD_TEMPLATE.format(i)
            idx.save(os.path.join(directory, name),
                     serve_spec=self._spec.serve)
            table.append({"path": name, "base": base,
                          "n_keys": int(idx.design.data.n),
                          "cost": float(idx.cost)})
        manifest = {
            "version": 1,
            "spec": self._spec.to_dict(),
            "shard_map": self._shard_map.to_dict(),
            "profile": self._profile_name,
            "profile_params": profile_to_dict(self._profile),
            "shards": table,
        }
        tmp = os.path.join(directory, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
        self._directory = directory
        return self

    # -- queries ------------------------------------------------------------
    def lookup(self, keys) -> np.ndarray:
        """Batched Alg. 1 across shards → (q, 2) int64 *global* byte
        ranges (each shard's base added back), in input order."""
        q = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        out = np.empty((len(q), 2), dtype=np.int64)
        for sid, pos in self._shard_map.sub_batches(q):
            out[pos] = self._shards[sid].lookup(q[pos]) + self._bases[sid]
        return out

    # -- serving ------------------------------------------------------------
    def serve(self, spec: ServeSpec | None = None,
              total_cache_bytes: int | None = None,
              backend_factories=None, *, device=None,
              **overrides) -> FleetService:
        """Open a :class:`FleetService` over the saved shard files.

        The serve template is the fleet spec's ``serve`` (or ``spec=``),
        with ServeSpec keyword ``overrides`` applied to every shard.  When
        a global budget is set (``total_cache_bytes=`` here, else the
        spec's ``cache_budget_bytes``), each shard's ``cache_bytes`` is
        replaced by its share under the marginal-gain allocation
        (:func:`repro_torch.fleet.allocate_cache_budget`), traffic-weighted
        by persisted per-shard ServeStats when present — hot shards earn
        more cache.  ``device`` (default: this Fleet's) is where every
        shard's resident descent runs."""
        if self._directory is None:
            raise ValueError(
                "serve() needs a saved fleet: call save(directory) first "
                "(or open an existing one with Fleet.open)")
        profile = overrides.pop("profile", _MISSING)
        if profile is _MISSING:
            profile = self._profile if self._profile is not None \
                else "azure_ssd"
        template = spec if spec is not None else self._spec.serve
        if overrides:
            template = template.replace(**overrides)
        template.validate()
        budget = self._spec.cache_budget_bytes \
            if total_cache_bytes is None else int(total_cache_bytes)
        plan = None
        specs = [template] * len(self._shards)
        if budget > 0:
            plan = self.allocate_cache(budget, profile=profile)
            specs = [
                template.replace(cache_bytes=split_cache_tiers(
                    plan.for_shard(i), template.cache_bytes,
                    quantum=self._spec.quantum))
                for i in range(len(self._shards))]
        paths = [idx.path for idx in self._shards]
        return FleetService(self._shard_map, paths, self._bases,
                            profile=profile, specs=specs, plan=plan,
                            backend_factories=backend_factories,
                            device=device if device is not None
                            else self._device)

    def allocate_cache(self, total_bytes: int, profile=None) -> CachePlan:
        """The marginal-gain cache plan for a given budget: per-shard
        demands (Eq. 6 saving × observed traffic ÷ working set) fed to
        greedy water-filling.  Traffic weights come from each shard's
        persisted ``<shard>.stats.json`` (uniform when absent)."""
        prof, _ = resolve_profile(profile if profile is not None
                                  else self._profile)
        if prof is None:
            raise ValueError("allocate_cache needs a storage profile")
        cache_prof, _ = resolve_profile(self._spec.serve.cache_profile)
        res = self._spec.serve.resident_layers
        demands = []
        for i, idx in enumerate(self._shards):
            traffic = 1.0
            if idx.path is not None:
                stats = load_serve_stats(idx.path)
                if stats is not None and stats.queries > 0:
                    traffic = float(stats.queries)
            meta = idx.file_meta
            if idx._result is not None:
                ws = cacheable_working_set(meta, res) \
                    if meta is not None else None
                demands.append(demand_from_design(
                    i, idx.design, prof, cache=cache_prof,
                    resident_layers=res, traffic=traffic, working_set=ws))
            elif meta is not None:
                demands.append(demand_from_meta(
                    i, meta, prof, cache=cache_prof,
                    resident_layers=res, traffic=traffic))
            else:
                raise ValueError(f"shard {i} has neither a built design "
                                 f"nor a file meta to derive demand from")
        return allocate_cache_budget(demands, total_bytes,
                                     quantum=self._spec.quantum)

    # -- observe → retune ----------------------------------------------------
    def retune(self, profile=None, data: KeyPositions | None = None,
               warm_start: bool = True, measured: bool = False,
               **tune_overrides) -> "Fleet":
        """Re-run every shard's search against its OWN observed serving
        conditions: each shard's persisted ServeStats yields its observed
        :class:`CachedProfile` (hit rate over the backing tier; shards
        without stats retune for the plain backing tier), and each search
        is warm-started from that shard's previous design through the
        shared fleet LayerCache.  Returns a fresh unsaved Fleet; the
        original is untouched."""
        backing, bname = resolve_profile(profile if profile is not None
                                         else self._profile)
        if backing is None:
            raise ValueError("retune needs a storage profile")
        cache_prof, _ = resolve_profile(self._spec.serve.cache_profile)
        parts = [None] * len(self._shards)
        if data is not None:
            parts, bases = _partition(data, self._shard_map)
            if bases != self._bases:
                raise ValueError(
                    f"data does not match this fleet: re-partitioned "
                    f"bases {bases} != recorded {self._bases}")
        spec = self._spec
        if tune_overrides:
            spec = spec.replace(tune=spec.tune.replace(**tune_overrides))
        new_shards = []
        for i, idx in enumerate(self._shards):
            shard_prof = backing
            if idx.path is not None:
                stats = load_serve_stats(idx.path)
                if stats is not None and stats.queries > 0:
                    shard_prof = observed_profile_from_stats(
                        stats, backing, cache_prof, measured=measured)
            idx._layer_cache = self._layer_cache   # fleet-wide build memo
            new = idx.retune(shard_prof, data=parts[i],
                             warm_start=warm_start,
                             **(tune_overrides or {}))
            new_shards.append(new)
        return self._successor(spec, new_shards, backing, bname)

    def _successor(self, spec, shards, profile, profile_name) -> "Fleet":
        """A fresh unsaved Fleet over retuned ``shards`` that runs where
        this one does and shares its build memo."""
        out = Fleet(spec=spec, shard_map=self._shard_map, shards=shards,
                    bases=self._bases, profile=profile,
                    profile_name=profile_name, device=self._device,
                    score_backend=self._score_backend)
        out._layer_cache = self._layer_cache
        return out

    def retune_budgeted(self, profile=None, data: KeyPositions | None = None,
                        total_cache_bytes: int | None = None,
                        warm_start: bool = True):
        """Joint per-shard design × global cache budget retune — one round
        of coordinate descent over the coupled problem (each shard's
        optimal design depends on its hit rate; its hit rate depends on
        its cache share; its *deserved* share depends on its design):

        1. **tentative**: retune every shard for the fully-warmed cache
           tier (``CachedProfile`` at hit rate 1 — the steady-state
           cached path), yielding each shard's fine candidate design and
           its cacheable working set;
        2. **allocate**: water-fill the global budget over the tentative
           designs' Eq. 6 curves (:func:`allocate_cache_budget`), traffic-
           weighted by persisted per-shard ServeStats — hot shards earn
           their working sets first;
        3. **final**: retune each shard for its *planned* hit rate
           ``h_i = alloc_i / ws_i`` — shards whose working set fits keep
           the fine steady-state design; shards priced out of the budget
           fall back toward the raw-tier design (coarse, no cache
           dependence), which is exactly right for an uncached shard.

        Returns ``(fleet, plan)``: a fresh unsaved Fleet (with
        ``cache_budget_bytes`` recorded so save→serve re-allocates
        consistently) and the step-2 :class:`CachePlan`."""
        backing, bname = resolve_profile(profile if profile is not None
                                         else self._profile)
        if backing is None:
            raise ValueError("retune_budgeted needs a storage profile")
        cache_prof, _ = resolve_profile(self._spec.serve.cache_profile)
        budget = self._spec.cache_budget_bytes \
            if total_cache_bytes is None else int(total_cache_bytes)
        if budget <= 0:
            raise ValueError("retune_budgeted needs a positive cache "
                             "budget (total_cache_bytes= or the spec's "
                             "cache_budget_bytes)")
        parts = [None] * len(self._shards)
        if data is not None:
            parts, bases = _partition(data, self._shard_map)
            if bases != self._bases:
                raise ValueError(
                    f"data does not match this fleet: re-partitioned "
                    f"bases {bases} != recorded {self._bases}")
        res = self._spec.serve.resident_layers
        warmed = CachedProfile(backing=backing, cache=cache_prof,
                               hit_rate=1.0)
        # 1. tentative steady-state designs (shared LayerCache: their
        #    builds seed both the final searches and later retunes)
        tentative, demands = [], []
        for i, idx in enumerate(self._shards):
            idx._layer_cache = self._layer_cache
            t = idx.retune(warmed, data=parts[i], warm_start=warm_start)
            t._layer_cache = self._layer_cache
            t.build()
            tentative.append(t)
            traffic = 1.0
            if idx.path is not None:
                stats = load_serve_stats(idx.path)
                if stats is not None and stats.queries > 0:
                    traffic = float(stats.queries)
            demands.append(demand_from_design(
                i, t.result.design, backing, cache=cache_prof,
                resident_layers=res, traffic=traffic))
        # 2. marginal-gain water-filling over the tentative curves
        plan = allocate_cache_budget(demands, budget,
                                     quantum=self._spec.quantum)
        # 3. final per-shard retune at the planned hit rate
        new_shards = []
        for i, (t, d) in enumerate(zip(tentative, demands)):
            h = min(1.0, plan.for_shard(i) / d.working_set) \
                if d.working_set > 0 else 0.0
            if h >= 1.0:
                new_shards.append(t)       # the steady-state design IS it
                continue
            prof_i = backing if h <= 0.0 else CachedProfile(
                backing=backing, cache=cache_prof, hit_rate=h)
            self._shards[i]._layer_cache = self._layer_cache
            new = self._shards[i].retune(prof_i, data=parts[i],
                                         warm_start=warm_start)
            new._layer_cache = self._layer_cache
            new_shards.append(new)
        spec = self._spec.replace(cache_budget_bytes=budget)
        return self._successor(spec, new_shards, backing, bname), plan

    def close(self) -> None:
        for idx in self._shards:
            idx.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection ------------------------------------------------------
    @property
    def spec(self) -> FleetSpec:
        return self._spec

    @property
    def shard_map(self) -> ShardMap:
        return self._shard_map

    @property
    def shards(self) -> list:
        """The per-shard :class:`repro_torch.api.Index` handles, in shard
        order."""
        return list(self._shards)

    @property
    def bases(self) -> list:
        return list(self._bases)

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def directory(self) -> str | None:
        return self._directory

    @property
    def costs(self) -> list:
        """Per-shard Eq. 6 costs (recorded costs for disk-opened shards)."""
        return [idx.cost for idx in self._shards]

    def describe(self) -> str:
        loc = f" @ {self._directory}" if self._directory else ""
        costs = ", ".join(
            f"{c * 1e6:.1f}us" if np.isfinite(c) else "?" for c in self.costs)
        return (f"Fleet(n_shards={self.n_shards}, "
                f"profile={self._profile_name or 'custom'}, "
                f"budget={self._spec.cache_budget_bytes}B, "
                f"costs=[{costs}]{loc})")
