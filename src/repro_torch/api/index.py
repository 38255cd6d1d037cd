"""The :class:`Index` facade — one object from tune → disk → serve.

::

    idx = Index.tune(D, "azure_ssd", TuneSpec(k=5, page_bytes=4096))
    idx.build()                   # run the search (implicit on first use)
    idx.save("index.air")         # paged layout + TuneSpec provenance
    ranges = idx.lookup(keys)     # in-memory batched Alg. 1 (float64)

    idx2 = Index.open("index.air", data=D)     # remembers its TuneSpec
    svc = idx2.serve(profile="azure_hdd", persist_stats=True)
    report = idx2.observe(svc)                 # drift check
    idx3 = idx2.retune(report.observed_profile, warm_start=True)

The port's facade is the JAX package's ``repro.api.Index`` with the same
files, designs and costs.  Where the port runs differs only in two
keyword-only arguments of the constructors, ``device`` and
``score_backend``: they are forwarded to the strategies that accept them
and ``device`` to :class:`repro_torch.serve.IndexService`.  They are not
``TuneSpec`` fields, so they never enter the file meta.  ``None`` keeps
the defaults: ranking and the resident descent on the card.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from repro_torch.core.airtune import TuneResult, TuneStats
from repro_torch.core.keyset import KeyPositions
from repro_torch.core.latency import IndexDesign, expected_latency
from repro_torch.core.lookup import lookup_batch
from repro_torch.core.nodes import BandLayer, StepLayer, outline
from repro_torch.core.registry import SEARCH_STRATEGIES
from repro_torch.core.serialize import (SerializedIndex, materialize_design,
                                        read_meta_path, write_index)
from repro_torch.core.storage import (PROFILES, StorageProfile,
                                      normalize_objective, profile_from_dict,
                                      profile_to_dict)
from repro_torch.core.sweep import DEFAULT_CACHE_ENTRIES, LayerCache

from .spec import ServeSpec, TuneSpec

#: valid Index.serve() keyword overrides (besides ``profile``)
_SERVE_FIELDS = frozenset(f.name for f in dataclasses.fields(ServeSpec))
_MISSING = object()


def resolve_profile(profile) -> tuple[StorageProfile | None, str | None]:
    """Accept a profile name, a StorageProfile, or None → (profile, name)."""
    if profile is None:
        return None, None
    if isinstance(profile, str):
        try:
            return PROFILES[profile], profile
        except KeyError:
            raise KeyError(
                f"unknown storage profile {profile!r}; named profiles: "
                f"{', '.join(sorted(PROFILES))}") from None
    if isinstance(profile, StorageProfile):
        return profile, getattr(profile, "name", None)
    raise TypeError(f"profile must be a name, StorageProfile, or None; "
                    f"got {type(profile).__name__}")


# ---------------------------------------------------------------------------
# warm-start seed recovery
# ---------------------------------------------------------------------------
# Step layers lose their node grouping on disk (materialize_design treats
# each piece as a node) and band layers lose clamp_lo; seeding the search's
# LayerCache with such a layer would poison the memo.  These helpers
# restore the exact build, per family discipline, before seeding.
_STEP_GROUPING = {
    "gstep": lambda b: int(b.p),
}
_BAND_KINDS = frozenset({"gband", "eband", "pgm", "rmi_leaf"})


def _btree_grouping(b) -> int:
    from repro_torch.core.baselines import btree_fanout
    return btree_fanout(b.lam)


_STEP_GROUPING["btree"] = _btree_grouping


def _canonical_seed_layer(layer, builder, cur: KeyPositions):
    """The layer exactly as ``builder`` would (re)build it on ``cur``, or
    None when fidelity cannot be guaranteed (unknown family discipline)."""
    if isinstance(layer, StepLayer):
        grouping = _STEP_GROUPING.get(builder.kind)
        if grouping is None:
            return None
        p = max(grouping(builder), 1)
        P = layer.n_pieces
        off = np.append(np.arange(0, P, p, dtype=np.int64), np.int64(P))
        return StepLayer(piece_keys=layer.piece_keys,
                         piece_pos=layer.piece_pos, node_piece_off=off)
    if isinstance(layer, BandLayer) and builder.kind in _BAND_KINDS:
        # fit_bands_for_groups anchors clamp_lo at the collection's first
        # position; the file format only records clamp_hi (end_pos)
        return dataclasses.replace(layer, clamp_lo=int(cur.lo[0]))
    return None


def recover_seed_layers(builder_names, layers, builders,
                        data: KeyPositions) -> list:
    """Reconstruct warm-start ``(name, layer)`` seed pairs from a
    disk-materialized design and its recorded builder provenance.  Stops
    at the first layer whose recorded builder is absent from ``builders``
    or whose family discipline cannot be restored bit-exactly."""
    by_name = {b.name: b for b in builders}
    out: list = []
    cur = data
    for name, layer in zip(builder_names, layers):
        b = by_name.get(name)
        if b is None:
            break
        fixed = _canonical_seed_layer(layer, b, cur)
        if fixed is None:
            break
        out.append((name, fixed))
        cur = outline(fixed, cur)
    return out


def _strategy_accepts(strategy, name: str) -> bool:
    """Third-party strategies need not accept the built-ins' extended
    kwargs — pass them only when the signature does."""
    try:
        params = inspect.signature(strategy).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class Index:
    """Facade over the full index lifecycle; construct via
    :meth:`tune`, :meth:`from_design`, or :meth:`open`."""

    def __init__(self, *, data=None, profile=None, profile_name=None,
                 spec=None, serve_spec=None, result=None, path=None,
                 file_meta=None, device=None, score_backend=None):
        self._data: KeyPositions | None = data
        self._profile: StorageProfile | None = profile
        self._profile_name: str | None = profile_name
        self._spec: TuneSpec | None = spec
        self._serve_spec: ServeSpec | None = serve_spec
        self._result: TuneResult | None = result
        self._path: str | None = path
        self._file_meta = file_meta
        # where the port runs: never written to the file
        self._device = device
        self._score_backend = score_backend
        # opened from disk (vs declared via tune/from_design): the file IS
        # the design — never silently re-search on attribute access
        self._from_disk = file_meta is not None and result is None
        self._disk_design: IndexDesign | None = None
        self._handle: SerializedIndex | None = None
        # warm-start state: a LayerCache retained across build/retune and
        # the previous design's (builder_name, layer) seed pairs
        self._layer_cache: LayerCache | None = None
        self._seed_layers: list | None = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def tune(cls, data: KeyPositions, profile, spec: TuneSpec | None = None,
             *, device=None, score_backend=None, **overrides) -> "Index":
        """Declare a tuning problem: Θ* = argmin L_SM(X; Θ, T) under
        ``spec``.  The search runs on :meth:`build` (implicitly triggered
        by ``design`` / ``save`` / ``lookup``).  ``overrides`` are
        TuneSpec field replacements, e.g. ``strategy="beam"``."""
        spec = spec if spec is not None else TuneSpec()
        if overrides:
            spec = spec.replace(**overrides)
        prof, pname = resolve_profile(profile)
        if prof is None:
            raise ValueError("Index.tune requires a storage profile")
        return cls(data=data, profile=prof, profile_name=pname, spec=spec,
                   device=device, score_backend=score_backend)

    @classmethod
    def from_design(cls, design: IndexDesign, spec: TuneSpec | None = None,
                    profile=None, *, device=None,
                    score_backend=None) -> "Index":
        """Wrap an explicitly-built design in the facade lifecycle.
        ``cost`` is evaluated via Eq. (6) when a profile is given, else
        NaN."""
        prof, pname = resolve_profile(profile)
        cost = expected_latency(design, prof) if prof is not None \
            else float("nan")
        result = TuneResult(design=design, cost=cost, stats=TuneStats(),
                            strategy="manual", builder_names=())
        return cls(data=design.data, profile=prof, profile_name=pname,
                   spec=spec, result=result, device=device,
                   score_backend=score_backend)

    @classmethod
    def open(cls, path: str, data: KeyPositions | None = None, *,
             device=None, score_backend=None) -> "Index":
        """Open a serialized index (written by either package).  The
        recorded :class:`TuneSpec` and :class:`ServeSpec` are restored;
        pass ``data`` to enable full materialization (``.design``) and
        :meth:`retune`."""
        meta = read_meta_path(path)
        spec = sspec = prof = pname = None
        if meta.tune:
            if meta.tune.get("spec") is not None:
                try:
                    spec = TuneSpec.from_dict(meta.tune["spec"])
                except (TypeError, ValueError):
                    spec = None   # forward/hand-edited provenance must not
                    #               make a readable file unopenable
            if meta.tune.get("serve") is not None:
                try:
                    sspec = ServeSpec.from_dict(meta.tune["serve"])
                except (TypeError, ValueError):
                    sspec = None
            pname = meta.tune.get("profile")
            # full parameters first (measured/custom tiers), name fallback
            prof = profile_from_dict(meta.tune.get("profile_params"))
            if prof is None and pname in PROFILES:
                prof = PROFILES[pname]
        return cls(path=path, file_meta=meta, data=data, spec=spec,
                   serve_spec=sspec, profile=prof, profile_name=pname,
                   device=device, score_backend=score_backend)

    # -- lifecycle ----------------------------------------------------------
    def build(self) -> "Index":
        """Run the configured search strategy (idempotent).  For an Index
        opened from disk this is a no-op — the file already holds the
        design; use :meth:`retune` to search again."""
        if self._from_disk:
            return self
        if self._result is None:
            if self._data is None:
                raise ValueError("no data to build from")
            if self._profile is None:
                raise ValueError("no storage profile to tune for")
            if self._spec is None:
                self._spec = TuneSpec()
            spec = self._spec.validate()
            strategy = SEARCH_STRATEGIES.get(spec.strategy)
            kwargs = {}
            if _strategy_accepts(strategy, "layer_cache"):
                # retained so a later warm retune reuses every build;
                # bounded: an observe→retune loop shares ONE cache
                if self._layer_cache is None:
                    self._layer_cache = LayerCache(
                        max_entries=DEFAULT_CACHE_ENTRIES)
                kwargs["layer_cache"] = self._layer_cache
            if self._seed_layers and _strategy_accepts(strategy,
                                                       "seed_layers"):
                kwargs["seed_layers"] = self._seed_layers
            if _strategy_accepts(strategy, "objective"):
                kwargs["objective"] = spec.objective
            elif normalize_objective(spec.objective) is not None:
                # a quantile objective silently tuned for the mean would
                # be the worst failure mode: loud refusal instead
                raise ValueError(
                    f"strategy {spec.strategy!r} does not accept the "
                    f"'objective' kwarg; quantile objectives require an "
                    f"objective-aware strategy (built-ins: airtune, "
                    f"brute_force, beam)")
            for name in ("score_backend", "device"):
                value = getattr(self, f"_{name}")
                if value is not None and _strategy_accepts(strategy, name):
                    kwargs[name] = value
            self._result = strategy(self._data, self._profile,
                                    spec.builders(), k=spec.k,
                                    max_layers=spec.max_layers, **kwargs)
        return self

    def save(self, path: str, *, data_record: int = 0,
             page_bytes: int | None = None,
             serve_spec: ServeSpec | None = None) -> "Index":
        """Serialize (building first if needed) with TuneSpec provenance;
        the file is the JAX package's byte for byte.  ``page_bytes``
        defaults to the spec's; ``serve_spec`` (or one already attached)
        is recorded alongside, so a reopened index serves with it."""
        self.build()
        if self._result is None:       # disk-opened: nothing new to write
            raise ValueError(
                "save() needs an in-memory design: this Index was opened "
                "from disk; the file already exists (use retune() to search "
                "again, then save the result)")
        if page_bytes is None:
            pb = self._spec.page_bytes if self._spec is not None else 0
        else:
            pb = page_bytes
        # provenance must describe the file as written
        spec = self._spec.replace(page_bytes=pb) \
            if self._spec is not None else None
        if serve_spec is not None:
            self._serve_spec = serve_spec.validate()
        cost = float(self._result.cost)
        tune_meta = {
            "spec": spec.to_dict() if spec is not None else None,
            "serve": (self._serve_spec.to_dict()
                      if self._serve_spec is not None else None),
            "strategy": self._result.strategy,
            # NaN is not valid strict JSON — null out unknown costs
            "cost": cost if np.isfinite(cost) else None,
            "builder_names": list(self._result.builder_names),
            "objective": self._result.objective,
            "profile": self._profile_name,
            "profile_params": profile_to_dict(self._profile),
        }
        self._file_meta = write_index(path, self.design,
                                      data_record=data_record,
                                      page_bytes=pb, tune=tune_meta)
        self._path = path
        return self

    def serve(self, spec: ServeSpec | None = None, backend_factory=None,
              *, device=None, **overrides):
        """Open a batched :class:`repro_torch.serve.IndexService` on the
        saved file.  The tuned-for profile applies unless ``profile=``
        overrides it, and the :class:`ServeSpec` recorded at save time
        (else field defaults) configures the engine.  Keyword overrides
        are ServeSpec field replacements — e.g.
        ``idx.serve(profile="azure_hdd", persist_stats=True)``.
        ``device`` (default: this Index's) is where the resident prefix
        runs."""
        if self._path is None:
            raise ValueError(
                "serve() needs an on-disk index: call save(path) first "
                "(or open an existing file with Index.open)")
        from repro_torch.serve.index_service import IndexService
        profile = overrides.pop("profile", _MISSING)
        if profile is _MISSING:
            # the tuned-for tier; an untuned handle gets the engine default
            profile = self._profile if self._profile is not None \
                else "azure_ssd"
        base = spec if spec is not None else self._serve_spec
        if overrides:
            unknown = set(overrides) - _SERVE_FIELDS
            if unknown:
                raise TypeError(
                    f"serve() got unexpected keyword(s) {sorted(unknown)}; "
                    f"valid ServeSpec fields: {sorted(_SERVE_FIELDS)}")
            if overrides.get("cache_bytes", _MISSING) is None:
                overrides.pop("cache_bytes")   # None keeps engine defaults
            base = (base if base is not None
                    else ServeSpec()).replace(**overrides)
        return IndexService(self._path, profile=profile, spec=base,
                            backend_factory=backend_factory,
                            device=device if device is not None
                            else self._device)

    def observe(self, service=None, **kwargs):
        """Drift check against live serving → :class:`DriftReport`.  With
        no ``service``, falls back to :meth:`observe_offline` on this
        Index's file.  Keyword args pass through to ``detect_drift``."""
        from .drift import detect_drift
        if service is None:
            return self.observe_offline(**kwargs)
        return detect_drift(service, **kwargs)

    def observe_offline(self, path: str | None = None, **kwargs):
        """Drift check from the persisted stats snapshot next to the index
        file (``persist_stats=True`` serving writes it on close).  None
        when no snapshot exists yet."""
        path = path if path is not None else self._path
        if path is None:
            raise ValueError(
                "observe_offline() needs an on-disk index: call save(path) "
                "first (or open an existing file with Index.open)")
        from .drift import detect_drift_from_file
        return detect_drift_from_file(path, **kwargs)

    def retune(self, profile=None, data: KeyPositions | None = None,
               warm_start: bool = False, *, device=None,
               score_backend=None, **spec_overrides) -> "Index":
        """Re-tune with the recorded spec — e.g. for a new tier or an
        observed ``CachedProfile`` from a :class:`DriftReport`.  Returns a
        fresh unsaved :class:`Index`; the original is untouched.
        ``device`` and ``score_backend`` default to this Index's.

        ``warm_start=True`` seeds the new search with the previous design
        (from the in-memory result, or recovered from the file for a
        disk-opened Index) and shares this Index's retained
        :class:`~repro_torch.core.sweep.LayerCache`: pure memoization for
        ``airtune`` / ``brute_force`` (bit-identical result, less work);
        ``beam`` also starts its frontier from the previous stacks."""
        data = data if data is not None else self._data
        if data is None and self._result is not None:
            data = self._result.design.data
        if data is None:
            raise ValueError(
                "retune needs the data layer: pass data= (an Index opened "
                "from disk does not store it)")
        prof = profile if profile is not None else self._profile
        if prof is None:
            raise ValueError("retune needs a storage profile")
        spec = self._spec if self._spec is not None else TuneSpec()
        if spec_overrides:
            spec = spec.replace(**spec_overrides)
        new = Index.tune(
            data, prof, spec,
            device=device if device is not None else self._device,
            score_backend=(score_backend if score_backend is not None
                           else self._score_backend))
        if warm_start:
            if self._layer_cache is None:
                self._layer_cache = LayerCache(
                    max_entries=DEFAULT_CACHE_ENTRIES)
            new._layer_cache = self._layer_cache   # shared build memo
            new._seed_layers = self._warm_seed_layers(data, spec)
        return new

    def _warm_seed_layers(self, data: KeyPositions, spec: TuneSpec) -> list:
        """The previous design as ``(builder_name, layer)`` seed pairs —
        exact from the in-memory result, canonicalized from disk."""
        if self._result is not None:
            names = self._result.builder_names
            layers = self._result.design.layers
            if len(names) == len(layers):
                return list(zip(names, layers))
            return []
        if self._from_disk and self._path is not None:
            names = tuple((self._file_meta.tune or {})
                          .get("builder_names") or ())
            if not names:
                return []
            layers = materialize_design(self._path, data).layers
            return recover_seed_layers(names, layers, spec.builders(), data)
        return []

    def close(self) -> None:
        if self._handle is not None:
            self._handle.close()
            self._handle = None

    def __enter__(self) -> "Index":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        # disk lookups hold a SerializedIndex backend; don't leak it when
        # the caller skips the context-manager form
        try:
            self.close()
        except Exception:
            pass

    # -- queries ------------------------------------------------------------
    def lookup(self, keys) -> np.ndarray:
        """Batched Alg. 1 → ``(q, 2)`` int64 data-layer byte ranges.

        In-memory designs use the float64 :func:`lookup_batch`; disk-opened
        indexes use the partial-read :class:`SerializedIndex` walk.  Both
        share the same per-layer descent and agree bit for bit.  The card
        is reached through :func:`repro_torch.kernels.index_lookup.
        traverse_index`."""
        q = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
        if not self._from_disk:
            res = lookup_batch(self.design, q)
            return np.stack([np.asarray(res.lo, dtype=np.int64),
                             np.asarray(res.hi, dtype=np.int64)], axis=1)
        if self._handle is None:
            self._handle = SerializedIndex(self._path)
        return np.array([self._handle.lookup(int(x)) for x in q],
                        dtype=np.int64).reshape(len(q), 2)

    # -- introspection ------------------------------------------------------
    @property
    def design(self) -> IndexDesign:
        """The built :class:`IndexDesign` (searches / materializes lazily)."""
        if self._from_disk:
            if self._data is None:
                raise ValueError(
                    "cannot materialize the design without the data layer; "
                    "pass data= to Index.open")
            if self._disk_design is None:
                self._disk_design = materialize_design(self._path, self._data)
            return self._disk_design
        return self.build()._result.design

    @property
    def result(self) -> TuneResult:
        if self._from_disk:
            raise ValueError(
                "no in-memory tune result: this Index was opened from disk "
                "(see file_meta.tune for the recorded strategy/cost, or "
                "retune() to search again)")
        return self.build()._result

    @property
    def cost(self) -> float:
        """L_SM of the design; for a disk-opened Index, the recorded cost
        from the file meta (NaN when the file has no provenance)."""
        if self._from_disk:
            c = (self._file_meta.tune or {}).get("cost")
            return float(c) if c is not None else float("nan")
        return self.result.cost

    @property
    def stats(self) -> TuneStats:
        return self.result.stats

    @property
    def spec(self) -> TuneSpec | None:
        """The originating TuneSpec (None for files without provenance)."""
        return self._spec

    @property
    def serve_spec(self) -> ServeSpec | None:
        """The recorded ServeSpec (None: engine defaults serve)."""
        return self._serve_spec

    @property
    def profile(self) -> StorageProfile | None:
        return self._profile

    @property
    def path(self) -> str | None:
        return self._path

    @property
    def file_meta(self):
        return self._file_meta

    @property
    def layer_cache(self) -> LayerCache | None:
        """The build memo this Index retains for warm retunes (None
        before the first build or warm retune)."""
        return self._layer_cache

    def describe(self) -> str:
        if self._from_disk:
            t = self._file_meta.tune or {}
            cost = t.get("cost")
            fams = ",".join((t.get("spec") or {}).get("families") or ())
            names = "<-".join(t.get("builder_names") or ())
            return (f"Index(open: {self._path}, "
                    f"strategy={t.get('strategy') or 'unknown'}, "
                    f"recorded_cost="
                    f"{f'{cost * 1e6:.1f}us' if cost is not None else 'n/a'}, "
                    f"spec={'recorded' if self._spec is not None else 'none'}, "
                    f"families=[{fams}], builders=[{names}])")
        if self._result is not None:
            loc = f" @ {self._path}" if self._path else ""
            return self._result.describe() + loc
        # never launch the search just to format a status string
        return f"Index(unbuilt, spec={self._spec!r})"
