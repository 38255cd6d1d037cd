"""Batched index-serving engine with a tiered block cache.

:class:`IndexService` serves *batches* of keys against one serialized
index file:

  1. **resident layers** — the top ``spec.resident_layers`` index layers
     are pinned in memory at open (the root is always read in full, per
     Alg. 1) and descended in ONE fused dispatch per batch
     (:mod:`repro_torch.kernels.fused_descent`): ``backend="cuda"`` runs the
     packed prefix on the service's device — the hand-written kernel on a
     card — and ``backend="numpy"`` is the bit-exact float64 walk;
  2. **page cache** — the other layers are read in fixed-size pages that
     pass through a tiered LRU (:class:`TieredBlockCache`);
  3. **read coalescing** — all pages a batch misses are merged into maximal
     runs (:func:`repro_torch.core.descent.coalesce_ranges`) before any
     ``pread`` is issued;
  4. **two-stage pipeline** — :meth:`IndexService.lookup_batches` with
     ``spec.pipeline_depth > 0`` overlaps the descent + disk walk of batch
     *i* with the coalesced first-window preads of batches *i+1..i+depth*
     (a single background worker that only warms the cache).

Every byte comes through a :class:`repro_torch.serve.StorageBackend` under
the spec's :class:`repro_torch.api.RetryPolicy`, with per-page CRC32
verification.  :meth:`IndexService.swap` replaces the served file under
live traffic; with ``spec.persist_stats`` each epoch's :class:`ServeStats`
is persisted next to the index (``<path>.stats.json``, a rotating window)
on close and on swap, and the observed-profile fits turn a snapshot into
the ``T(Δ)`` a drift-triggered retune tunes for (:mod:`repro_torch.api.drift`).
The engine is the JAX package's ``repro.serve.index_service`` with the
same windows, cache contents, counters and stats files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from collections import OrderedDict

import numpy as np

from repro_torch.core.descent import coalesce_ranges, descend_layers
from repro_torch.core.serialize import (_BAND_DT, _STEP_DT, gallop_step,
                                        page_crc, page_span, parse_meta,
                                        predict_from_records,
                                        record_aligned_range, window_misses)
from repro_torch.core.storage import (PROFILES, CachedProfile,
                                      DistributionalProfile, MeasuredProfile,
                                      StorageProfile)
from repro_torch.kernels.fused_descent import (FusedDescent,
                                               fused_descent_with_backend,
                                               pack_prefix, resolve_device)
from repro_torch.serve.backend import (CorruptPageError,
                                       DeadlineExceededError, FileBackend,
                                       ReadError, StorageBackend)

DEFAULT_PAGE_BYTES = 4096

STATS_SUFFIX = ".stats.json"   # ServeStats snapshots live next to the index
STATS_WINDOW = 16              # rotating window: snapshots kept per file
READ_SAMPLE_CAP = 512          # measured (Δ, seconds) pread samples retained
LOOKUP_SAMPLE_CAP = 512        # per-lookup (n, wall) samples retained
MIN_FIT_SAMPLES = 8            # reservoir samples needed before any
#                                observed-profile fit says anything


def demo_serving_design(D):
    """Canonical 3-layer stack (step <- band <- step root): two disk layers
    below a resident root, so the block cache has something to do."""
    from repro_torch.core.builders import build_gband, build_gstep
    from repro_torch.core.latency import IndexDesign
    from repro_torch.core.nodes import outline
    l1 = build_gstep(D, 8, 2**10)
    o1 = outline(l1, D)
    l2 = build_gband(o1, 2**9)
    l3 = build_gstep(outline(l2, o1), 8, 2**7)
    return IndexDesign(layers=(l1, l2, l3), data=D)


# ---------------------------------------------------------------------------
# tiered LRU block cache
# ---------------------------------------------------------------------------
class TieredBlockCache:
    """LRU page cache with N capacity tiers (tier 0 = hottest).

    ``get`` probes tiers in order and promotes hits to tier 0; inserts
    cascade evictions downward (tier i's LRU page demotes to tier i+1, the
    last tier evicts to nothing) — an exclusive multi-level cache.
    """

    def __init__(self, capacities_bytes, page_bytes: int):
        caps = tuple(int(c) for c in capacities_bytes)
        assert caps and all(c >= 0 for c in caps), caps
        self.page_bytes = int(page_bytes)
        self.cap_pages = [c // self.page_bytes for c in caps]
        self.tiers = [OrderedDict() for _ in caps]
        self.hits = [0] * len(caps)
        self.misses = 0

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def __contains__(self, page_id) -> bool:
        return any(page_id in t for t in self.tiers)

    def get(self, page_id):
        """→ page bytes (promoting to tier 0) or None on a full miss."""
        for ti, tier in enumerate(self.tiers):
            if page_id in tier:
                data = tier.pop(page_id)
                self.hits[ti] += 1
                self._insert(page_id, data)
                return data
        self.misses += 1
        return None

    def peek(self, page_id):
        """→ page bytes without promotion or hit/miss accounting (the
        prefetch stage reads through this)."""
        for tier in self.tiers:
            if page_id in tier:
                return tier[page_id]
        return None

    def put(self, page_id, data) -> None:
        for tier in self.tiers:
            tier.pop(page_id, None)
        self._insert(page_id, data)

    def _insert(self, page_id, data) -> None:
        ti = 0
        while ti < len(self.tiers):
            tier = self.tiers[ti]
            tier[page_id] = data
            tier.move_to_end(page_id)
            if len(tier) <= self.cap_pages[ti]:
                return
            page_id, data = tier.popitem(last=False)   # demote the LRU page
            ti += 1

    def stats(self) -> dict:
        return {"hits_per_tier": list(self.hits), "hits": sum(self.hits),
                "misses": self.misses,
                "pages_resident": [len(t) for t in self.tiers]}


# ---------------------------------------------------------------------------
# serving statistics
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServeStats:
    queries: int = 0
    batches: int = 0
    preads: int = 0             # coalesced reads actually issued
    ranges_requested: int = 0   # per-query per-layer ranges before merging
    pages_fetched: int = 0
    pages_hit: int = 0
    bytes_fetched: int = 0      # from storage, excluding open-time reads
    bytes_from_cache: int = 0
    open_bytes: int = 0         # root + resident layers read at open
    retries: int = 0            # window extensions (band inter-key misses)
    io_retries: int = 0         # failed pread attempts that were retried
    io_timeouts: int = 0        # preads past the per-pread deadline
    degraded_runs: int = 0      # coalesced runs split to page granularity
    corrupt_pages: int = 0      # CRC32 failures detected (each refetched once)
    swaps: int = 0              # live index hot-swaps performed (counted on
    #                             the service's new epoch stats)
    device_batches: int = 0     # batches whose resident descent ran fused
    #                             on the "cuda" backend
    pipelined_batches: int = 0  # batches served through lookup_batches'
    #                             two-stage pipeline
    overlapped_preads: int = 0  # preads issued by the prefetch stage
    modeled_seconds: float = 0.0   # Σ T(Δ) under the configured profile
    open_modeled_seconds: float = 0.0  # the open-time share of the above
    data_modeled_seconds: float = 0.0  # Σ T(hi−lo) of returned data ranges
    # roofline attribution (see .roofline()): measured wall inside the
    # fused resident descent vs Σ T(run) of every pread actually issued
    pread_modeled_seconds: float = 0.0
    descent_seconds: float = 0.0
    prefetch_seconds: float = 0.0
    overlapped_pread_seconds: float = 0.0  # measured wall of tagged preads
    # what the uncached Alg. 1 walk would pay for the same traffic under
    # the configured profile
    walk_modeled_seconds: float = 0.0
    pread_seconds: float = 0.0  # measured wall-clock inside the backend pread
    # seeded uniform reservoir (Vitter's Algorithm R) of measured
    # (Δ bytes, seconds, overlapped, tainted) pread samples
    read_samples: list = dataclasses.field(default_factory=list)
    reads_seen: int = 0         # total preads offered to the reservoir
    # seeded uniform reservoir of per-lookup (n_queries, wall seconds)
    lookup_samples: list = dataclasses.field(default_factory=list)
    lookups_seen: int = 0       # total lookup batches offered
    sample_seed: int = 0        # reservoir determinism knob

    @property
    def hit_rate(self) -> float:
        touched = self.pages_hit + self.pages_fetched
        return self.pages_hit / touched if touched else 0.0

    @property
    def bytes_saved(self) -> int:
        return self.bytes_from_cache

    @property
    def query_modeled_seconds(self) -> float:
        """Observed per-query E[T] through this engine (open-time reads
        amortized out), including the final data-range read."""
        if self.queries == 0:
            return float("nan")
        return (self.modeled_seconds - self.open_modeled_seconds
                + self.data_modeled_seconds) / self.queries

    @property
    def walk_query_seconds(self) -> float:
        """Per-query cost of the full-price (cacheless) Alg. 1 walk."""
        if self.queries == 0:
            return float("nan")
        return self.walk_modeled_seconds / self.queries

    def _reservoir_put(self, reservoir: list, cap: int, seen: int,
                       sample: tuple, salt: int) -> None:
        """Algorithm R step; the replacement draw is a pure function of
        (sample_seed, salt, seen), so a fixed seed replays the reservoir."""
        if len(reservoir) < cap:
            reservoir.append(sample)
            return
        rng = np.random.default_rng((int(self.sample_seed) & 0x7FFFFFFF,
                                     int(salt), int(seen)))
        j = int(rng.integers(0, seen))
        if j < cap:
            reservoir[j] = sample

    def record_read(self, nbytes: int, seconds: float,
                    overlapped: bool = False, tainted: bool = False) -> None:
        self.pread_seconds += seconds
        self.reads_seen += 1
        self._reservoir_put(self.read_samples, READ_SAMPLE_CAP,
                            self.reads_seen,
                            (int(nbytes), float(seconds), bool(overlapped),
                             bool(tainted)), salt=0)

    def record_lookup(self, n_queries: int, wall_seconds: float) -> None:
        """Feed one lookup batch's wall time into the per-lookup reservoir."""
        self.lookups_seen += 1
        self._reservoir_put(self.lookup_samples, LOOKUP_SAMPLE_CAP,
                            self.lookups_seen,
                            (int(n_queries), float(wall_seconds)), salt=1)

    def lookup_quantile(self, p: float) -> float | None:
        """Online per-query wall-latency ``p``-quantile estimate: each
        reservoir entry contributes its per-query average weighted by its
        batch size.  None before any lookups are recorded."""
        if not self.lookup_samples:
            return None
        if not 0.0 < float(p) < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        vals = np.asarray([s / max(int(n), 1)
                           for n, s in self.lookup_samples], dtype=np.float64)
        w = np.asarray([max(int(n), 1) for n, _ in self.lookup_samples],
                       dtype=np.float64)
        order = np.argsort(vals, kind="stable")
        vals, w = vals[order], w[order]
        pos = (np.cumsum(w) - 0.5 * w) / w.sum()
        return float(np.interp(float(p), pos, vals))

    def roofline(self) -> dict:
        """Compute-vs-I/O attribution of served traffic: measured wall
        inside the fused resident descent vs the modeled cost ``Σ T(run)``
        of every pread issued under the deployment tier."""
        compute = float(self.descent_seconds)
        io = float(self.pread_modeled_seconds)
        total = compute + io
        return {
            "compute_seconds": compute,
            "io_seconds": io,
            "io_fraction": (io / total) if total > 0 else None,
            "bound": (("pread" if io >= compute else "descent")
                      if total > 0 else None),
        }

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["read_samples"] = [[int(r[0]), float(r[1]), bool(r[2]), bool(r[3])]
                             for r in self.read_samples]
        d["lookup_samples"] = [[int(r[0]), float(r[1])]
                               for r in self.lookup_samples]
        d["hit_rate"] = self.hit_rate
        d["roofline"] = self.roofline()
        d["lookup_p50_seconds"] = self.lookup_quantile(0.5)
        d["lookup_p99_seconds"] = self.lookup_quantile(0.99)
        # NaN (no queries yet) is not valid strict JSON — null it out
        for key in ("query_modeled_seconds", "walk_query_seconds"):
            v = getattr(self, key)
            d[key] = v if np.isfinite(v) else None
        return d

    @classmethod
    def from_snapshot(cls, d: dict) -> "ServeStats":
        """Inverse of :meth:`snapshot` (derived and unknown keys are
        dropped).  2- and 3-element read samples of older snapshots load
        as non-overlapped and non-tainted."""
        if not isinstance(d, dict):
            raise TypeError(f"snapshot must be an object, "
                            f"got {type(d).__name__}")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            f = fields.get(k)
            if f is None or k in ("read_samples", "lookup_samples"):
                continue
            kw[k] = int(v) if isinstance(f.default, int) else float(v)
        kw["read_samples"] = [
            (int(r[0]), float(r[1]),
             bool(r[2]) if len(r) > 2 else False,
             bool(r[3]) if len(r) > 3 else False)
            for r in d.get("read_samples", [])]
        kw["lookup_samples"] = [(int(r[0]), float(r[1]))
                                for r in d.get("lookup_samples", [])]
        st = cls(**kw)
        st.reads_seen = max(st.reads_seen, len(st.read_samples))
        st.lookups_seen = max(st.lookups_seen, len(st.lookup_samples))
        return st


# ---------------------------------------------------------------------------
# ServeStats persistence (the observe → retune loop)
# ---------------------------------------------------------------------------
def stats_path(index_path: str) -> str:
    """Where an index file's ServeStats snapshots live (next to the meta)."""
    return index_path + STATS_SUFFIX


def save_stats_snapshot(index_path: str, stats: ServeStats, *,
                        profile_name: str | None = None,
                        window: int = STATS_WINDOW) -> str:
    """Append one snapshot to ``<index_path>.stats.json``, keeping only the
    last ``window`` snapshots (rotating).  Returns the stats-file path."""
    path = stats_path(index_path)
    history = load_stats_history(index_path)
    history.append({"profile": profile_name, "stats": stats.snapshot()})
    history = history[-max(int(window), 1):]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "snapshots": history}, f)
    os.replace(tmp, path)      # atomic: a reader never sees a torn file
    return path


def load_stats_history(index_path: str) -> list:
    """All persisted snapshots (oldest first); [] when none/unreadable.

    Never raises: a file that cannot be decoded warns and loads as empty,
    and malformed snapshot entries are skipped with a warning."""
    path = stats_path(index_path)
    try:
        with open(path) as f:
            d = json.load(f)
    except OSError:
        return []          # no snapshot yet: the normal cold-start case
    except ValueError:
        warnings.warn(f"corrupt stats file {path!r}: not valid JSON; "
                      f"treating as empty", RuntimeWarning, stacklevel=2)
        return []
    if not isinstance(d, dict):
        warnings.warn(f"corrupt stats file {path!r}: expected an object, "
                      f"got {type(d).__name__}; treating as empty",
                      RuntimeWarning, stacklevel=2)
        return []
    snaps = d.get("snapshots") or []
    if not isinstance(snaps, list):
        warnings.warn(f"corrupt stats file {path!r}: 'snapshots' is not a "
                      f"list; treating as empty", RuntimeWarning,
                      stacklevel=2)
        return []
    good = [s for s in snaps if isinstance(s, dict)]
    if len(good) != len(snaps):
        warnings.warn(f"stats file {path!r}: skipped "
                      f"{len(snaps) - len(good)} malformed snapshot(s)",
                      RuntimeWarning, stacklevel=2)
    return good


def load_serve_stats(index_path: str) -> ServeStats | None:
    """The latest loadable persisted :class:`ServeStats` of an index file;
    snapshots that fail to decode are skipped newest-first, with a
    warning."""
    for snap in reversed(load_stats_history(index_path)):
        try:
            return ServeStats.from_snapshot(snap["stats"])
        except (KeyError, TypeError, ValueError, IndexError):
            warnings.warn(
                f"stats file {stats_path(index_path)!r}: skipping a "
                f"snapshot that does not decode as ServeStats",
                RuntimeWarning, stacklevel=2)
    return None


def cacheable_working_set(meta, resident_layers: int = 1) -> int:
    """Bytes the block cache can usefully hold for an index file: the
    serialized sizes of every non-resident layer."""
    L = len(meta.layers)
    n_res = min(max(int(resident_layers), 1), L) if L else 0
    return int(sum(lm.size for lm in meta.layers[:L - n_res]))


def untainted_read_samples(stats: ServeStats) -> list:
    """Reservoir samples eligible for any profile fit: reads tagged
    ``tainted`` (retried, past a deadline, or repairing a corrupt page)
    measure the fault, not the tier, and are never fitted."""
    return [r for r in stats.read_samples if not (len(r) > 3 and r[3])]


def _fit_eligible_samples(stats: ServeStats, min_samples: int) -> list:
    """Untainted samples, without the ``overlapped`` (prefetch-stage) ones
    whenever enough blocking samples remain."""
    clean = untainted_read_samples(stats)
    blocking = [r for r in clean if not (len(r) > 2 and r[2])]
    return blocking if len(blocking) >= min_samples else clean


def measured_backing_profile(
        stats: ServeStats,
        min_samples: int = MIN_FIT_SAMPLES) -> MeasuredProfile | None:
    """Monotone ``T(Δ)`` through the measured pread samples (per-size
    median wall-clock); None with too few eligible samples or sizes."""
    samples = _fit_eligible_samples(stats, min_samples)
    if len(samples) < min_samples:
        return None
    sizes = np.asarray([r[0] for r in samples], dtype=np.float64)
    secs = np.asarray([r[1] for r in samples], dtype=np.float64)
    uniq = np.unique(sizes)
    if len(uniq) < 2:
        return None
    med = [float(np.median(secs[sizes == u])) for u in uniq]
    return MeasuredProfile(deltas=tuple(float(u) for u in uniq),
                           seconds=tuple(med), name="observed-preads")


def distributional_backing_profile(
        stats: ServeStats, min_samples: int = MIN_FIT_SAMPLES,
        qs=(0.5, 0.9, 0.95, 0.99)) -> DistributionalProfile | None:
    """Per-Δ latency distributions from the pread reservoir, with the
    eligibility of :func:`measured_backing_profile`."""
    samples = _fit_eligible_samples(stats, min_samples)
    return DistributionalProfile.fit(
        [(r[0], r[1]) for r in samples], min_samples=min_samples, qs=qs,
        name="observed-pread-dist")


def observed_profile_from_stats(stats: ServeStats, backing: StorageProfile,
                                cache: StorageProfile | None = None, *,
                                measured: bool = True,
                                min_samples: int = MIN_FIT_SAMPLES,
                                distributional: bool = False) -> CachedProfile:
    """Fold observed serving behavior into an effective ``T(Δ)``: the
    stats' hit rate over the measured backing fit (distributional first
    when asked, then the mean fit) where the samples support one, else
    over the modeled ``backing``.  A pure function of the snapshot."""
    eff = backing
    if measured:
        m = (distributional_backing_profile(stats, min_samples=min_samples)
             if distributional else None)
        if m is None:
            m = measured_backing_profile(stats, min_samples=min_samples)
        if m is not None:
            eff = m
    return CachedProfile(backing=eff, cache=cache, hit_rate=stats.hit_rate)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _ServeState:
    """One serving epoch: the storage backend, decoded meta, resident
    prefix (and its device module), block cache, page-CRC table and
    stats.  Lookups pin it for their whole batch (``pins`` under the
    service lock), so closing never releases a backend mid-descent."""

    __slots__ = ("path", "storage", "file_size", "meta", "tune_meta",
                 "page_bytes", "cache", "page_crcs", "prefix_lis", "prefix", "fused", "device_active",
                 "stats", "pins", "retired")

    def __init__(self, path: str, storage):
        self.path = path
        self.storage = storage
        self.stats = ServeStats()
        self.pins = 0
        self.retired = False


class IndexService:
    """Serve batched lookups against a serialized index file.

    Parameters
    ----------
    path:     index file written by :func:`repro_torch.core.write_index` (or
              by the JAX package's writer: the format is the same).
    profile:  storage tier of the file (name in ``PROFILES`` or a
              :class:`~repro_torch.core.StorageProfile`); drives
              ``modeled_seconds``.
    spec:     a :class:`repro_torch.api.ServeSpec`; ``None`` uses the spec
              recorded in the file meta when present, else defaults.
    backend_factory:
              ``path -> StorageBackend`` used to open the file; defaults to
              :class:`repro_torch.serve.FileBackend`.
    device:   where the resident prefix lives for the ``"cuda"`` backend.
              ``None`` is the card, and raises when there is none; pass
              ``"cpu"`` to run the plain PyTorch version instead.

    All epoch-specific objects live in a :class:`_ServeState`;
    ``meta``/``cache``/``stats``/... are properties onto the current epoch
    so :meth:`swap` can replace them atomically under live traffic.
    """

    def __init__(self, path: str, *, profile="azure_ssd", spec=None,
                 backend_factory=None, device=None):
        self._state = None          # __del__ must be safe mid-__init__
        self._final_state = None
        self._executor = None
        self._prefetch_exc = None
        self.device = resolve_device(device)
        self.path = path
        self._backend_factory = backend_factory or FileBackend
        self.profile = PROFILES[profile] if isinstance(profile, str) else profile
        # one lock covers cache + stats + the epoch pointer: the prefetch
        # worker shares them with the serving thread; preads themselves
        # (and their retry sleeps) run outside it
        self._mu = threading.Lock()
        st, spec = self._open_state(path, spec)
        self._apply_spec(spec)
        self._state = st

    def _apply_spec(self, spec) -> None:
        """Service-level views of a resolved (validated) ServeSpec."""
        self.spec = spec
        self.retry = spec.retry
        self.cache_profile = (PROFILES[spec.cache_profile]
                              if spec.cache_profile else None)
        self.coalesce_gap = int(spec.coalesce_gap)
        self.persist_stats = bool(spec.persist_stats)

    def _open_state(self, path: str, spec):
        """Open ``path`` into a fresh :class:`_ServeState` (meta read, spec
        resolution, CRC table, resident prefix, cold cache).  Returns
        ``(state, resolved_spec)``; the backend is closed on any failure."""
        from repro_torch.api.spec import RetryPolicy, ServeSpec
        storage = self._backend_factory(path)
        try:
            st = _ServeState(path, storage)
            st.file_size = int(storage.size())
            policy = spec.retry if spec is not None else RetryPolicy()
            st.meta = self._read_meta(st, policy)
            st.tune_meta = st.meta.tune
            if spec is None:
                spec = self._spec_from_meta(st.tune_meta)
            if spec is None:
                spec = ServeSpec()
            spec = spec.validate()
            policy = spec.retry
            # precedence: spec field > file's paged layout > default
            st.page_bytes = int(spec.page_bytes or st.meta.page_bytes
                                or DEFAULT_PAGE_BYTES)
            cache_bytes = spec.cache_bytes
            if not cache_bytes:   # TuneSpec-recorded capacities, then default
                tspec = (st.tune_meta or {}).get("spec") or {}
                cache_bytes = tuple(tspec.get("cache_bytes") or ()) or (1 << 20,)
            st.cache = TieredBlockCache(cache_bytes, st.page_bytes)
            # CRC table: file page id -> expected CRC32, only when the
            # engine pages exactly as the writer did
            st.page_crcs = None
            if spec.verify_checksums and st.page_bytes \
                    and st.page_bytes == st.meta.page_bytes:
                table = {}
                for lm in st.meta.layers:
                    if lm.page_crcs:
                        base = int(lm.offset) // st.page_bytes
                        for k, c in enumerate(lm.page_crcs):
                            table[base + k] = int(c)
                st.page_crcs = table or None

            L = len(st.meta.layers)
            n_res = min(max(int(spec.resident_layers), 1), L) if L else 0
            resident = {}
            for li in range(L - n_res, L):
                lm = st.meta.layers[li]
                raw = self._load_resident(st, lm, policy)
                resident[li] = self._parse_layer(lm, raw)
                with self._mu:
                    st.stats.open_bytes += lm.size
                    if self.profile is not None:
                        t = float(self.profile(lm.size))
                        st.stats.modeled_seconds += t
                        st.stats.open_modeled_seconds += t
            # the resident prefix, top-down (root first) — the fused
            # kernel's layer order; row L−1 of its output feeds the disk walk
            st.prefix_lis = list(range(L - 1, L - n_res - 1, -1))
            st.prefix = [resident[li] for li in st.prefix_lis]
            st.fused = None
            if spec.backend == "cuda" and st.prefix:
                packed = pack_prefix(st.prefix)
                if packed is not None:
                    st.fused = FusedDescent(packed, device=self.device)
            st.device_active = st.fused is not None
        except BaseException:
            storage.close()
            raise
        return st, spec

    def _read_meta(self, st, policy):
        """Decode the file header through the backend, retrying torn or
        failing header reads under ``policy``."""
        attempt = 0
        while True:
            try:
                return parse_meta(st.storage.pread)
            except (OSError, ValueError, KeyError, TypeError) as e:
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise ReadError(
                        f"could not read index meta from {st.path!r} after "
                        f"{attempt} attempt(s): {e}",
                        path=st.path, offset=0, attempts=attempt) from e
                with self._mu:
                    st.stats.io_retries += 1
                time.sleep(policy.backoff(attempt - 1))

    def _load_resident(self, st, lm, policy) -> bytes:
        """One resident layer's bytes, CRC-verified when the file carries
        checksums (resident bytes never pass the cache-fill check).  A
        corrupt layer is refetched once, then raises
        :class:`CorruptPageError`."""
        raw, dt, tainted = self._pread_retry(st, lm.size, lm.offset,
                                             policy=policy)
        P = st.page_bytes
        crcs = st.page_crcs and getattr(lm, "page_crcs", None)
        if crcs:
            base = int(lm.offset) // P
            bad = [k for k in range(len(crcs))
                   if page_crc(raw[k * P:(k + 1) * P], P)
                   != st.page_crcs.get(base + k)]
            if bad:
                with self._mu:
                    st.stats.corrupt_pages += len(bad)
                    st.stats.record_read(len(raw), dt, tainted=True)
                raw, dt, _ = self._pread_retry(st, lm.size, lm.offset,
                                               policy=policy)
                tainted = True
                still = [k for k in bad
                         if page_crc(raw[k * P:(k + 1) * P], P)
                         != st.page_crcs.get(base + k)]
                if still:
                    raise CorruptPageError(
                        f"resident layer page {base + still[0]} of "
                        f"{st.path!r} failed CRC32 verification twice",
                        path=st.path, page_id=base + still[0])
        with self._mu:
            st.stats.record_read(len(raw), dt, tainted=tainted)
        return raw

    def _spec_from_meta(self, tune_meta):
        """The ServeSpec recorded in the meta by the writer, or None."""
        d = (tune_meta or {}).get("serve")
        if d is None:
            return None
        from repro_torch.api.spec import ServeSpec
        try:
            return ServeSpec.from_dict(d)
        except (TypeError, ValueError):
            return None

    # -- epoch plumbing ------------------------------------------------------
    @property
    def _st(self):
        """Current epoch; after close, the final one (stats stay
        inspectable on a closed service)."""
        st = self._state
        return st if st is not None else self._final_state

    @property
    def meta(self):
        return self._st.meta

    @property
    def tune_meta(self):
        return self._st.tune_meta

    @property
    def stats(self) -> ServeStats:
        return self._st.stats

    @property
    def cache(self) -> TieredBlockCache:
        return self._st.cache

    @property
    def page_bytes(self) -> int:
        return self._st.page_bytes

    @property
    def device_active(self) -> bool:
        return self._st.device_active

    @property
    def _prefix(self) -> list:
        return self._st.prefix

    @property
    def storage(self) -> StorageBackend | None:
        """The current epoch's storage backend; None after close."""
        st = self._state
        return st.storage if st is not None else None

    def _pin(self) -> _ServeState:
        """Claim the current epoch for one batch (pair with :meth:`_unpin`)."""
        with self._mu:
            st = self._state
            if st is None:
                raise RuntimeError("IndexService is closed")
            st.pins += 1
            return st

    def _unpin(self, st: _ServeState) -> None:
        with self._mu:
            st.pins -= 1
            dead = st.retired and st.pins == 0
        if dead:
            st.storage.close()

    def _persist(self, st: _ServeState) -> None:
        """Best-effort snapshot of an epoch's stats (``persist_stats``)."""
        if not self.persist_stats:
            return
        try:
            save_stats_snapshot(st.path, st.stats,
                                profile_name=getattr(self.profile, "name",
                                                     None))
        except OSError:
            pass          # a read-only deployment must still close and swap

    def swap(self, path: str, *, spec=None) -> None:
        """Hot-swap serving to ``path`` (e.g. a freshly retuned index) under
        live traffic.  The new file is fully opened (meta, CRC table,
        resident prefix, cold cache, fresh :class:`ServeStats`) before the
        switch, and the switch is one pointer move under the service lock:
        batches in flight pinned the old epoch and finish on it; batches
        arriving after ``swap`` returns serve from the new one, so no
        result mixes two files.  The old epoch's stats are persisted
        (``persist_stats``) and its backend closes when its last batch
        unpins.  ``spec=None`` keeps the current spec; the fresh stats
        carry only the ``swaps`` counter forward."""
        if self._state is None:
            raise RuntimeError("swap() on a closed IndexService")
        st_new, resolved = self._open_state(
            path, spec if spec is not None else self.spec)
        with self._mu:
            old = self._state
            if old is None:            # closed while the new epoch opened
                st_new.storage.close()
                raise RuntimeError("swap() on a closed IndexService")
            st_new.stats.swaps = old.stats.swaps + 1
            self._state = st_new
            self.path = path
            old.retired = True
            dead = old.pins == 0
        if spec is not None:
            self._apply_spec(resolved)
        self._persist(old)
        if dead:
            old.storage.close()

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Idempotent; drains the prefetch worker, then (``persist_stats``)
        writes the final ServeStats snapshot to ``<path>.stats.json`` and
        releases the backend (at once, or when the last in-flight batch
        unpins)."""
        ex = getattr(self, "_executor", None)
        if ex is not None:
            ex.shutdown(wait=True)   # no prefetch pread may outlive the fd
            self._executor = None
        mu = getattr(self, "_mu", None)
        if mu is None or getattr(self, "_state", None) is None:
            return
        with mu:
            st, self._state = self._state, None
            if st is None:
                return
            self._final_state = st
            st.retired = True
            dead = st.pins == 0
        self._persist(st)
        if dead:              # stragglers (if any) close on last unpin
            st.storage.close()

    def __enter__(self) -> "IndexService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        # airlint: allow[typed-error-flow] -- best-effort finalizer; raising
        # from __del__ would crash interpreter shutdown, not surface errors
        except Exception:
            pass

    # -- layer materialization ---------------------------------------------
    @staticmethod
    def _parse_layer(lm, raw: bytes) -> dict:
        if lm.kind == "step":
            rec = np.frombuffer(raw, dtype=_STEP_DT)
            pos = rec["pos"].astype(np.int64)
            return {"kind": "step", "keys": rec["key"].copy(), "pos_lo": pos,
                    "pos_hi": np.append(pos[1:], np.int64(lm.end_pos))}
        rec = np.frombuffer(raw, dtype=_BAND_DT)
        return {"kind": "band", "x1": rec["x1"].copy(),
                "y1": rec["y1"].astype(np.float64), "m": rec["m"].copy(),
                "delta": rec["delta"].copy()}

    # -- fault-tolerant reads ------------------------------------------------
    def _pread_retry(self, st: _ServeState, nbytes: int, offset: int, *,
                     deadline: float | None = None, policy=None):
        """One logical read through the backend under the RetryPolicy →
        ``(data, seconds, tainted)``.

        A failed or short attempt backs off exponentially and retries up to
        ``max_attempts``, then raises :class:`ReadError`.  ``deadline`` is
        an absolute ``perf_counter`` horizon (the per-batch budget): past
        it no further attempt is issued and :class:`DeadlineExceededError`
        surfaces.  An attempt that outlives ``pread_deadline_s`` counts as
        a timeout; its good data still serves, but the sample is tainted."""
        policy = policy or self.retry
        nbytes, offset = int(nbytes), int(offset)
        want = max(min(nbytes, st.file_size - offset), 0)
        attempt = 0
        tainted = False
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                with self._mu:
                    st.stats.io_timeouts += 1
                raise DeadlineExceededError(
                    f"batch deadline expired before pread({nbytes} B @ "
                    f"{offset}) on {st.path!r}")
            err = None
            t0 = time.perf_counter()
            try:
                data = st.storage.pread(nbytes, offset)
            except OSError as e:
                data, err = b"", e
            dt = time.perf_counter() - t0
            pdl = policy.pread_deadline_s
            if pdl is not None and dt > pdl:
                tainted = True
                with self._mu:
                    st.stats.io_timeouts += 1
            if err is None and len(data) >= want:
                return data, dt, tainted
            attempt += 1
            if attempt >= policy.max_attempts:
                if err is not None:
                    raise ReadError(
                        f"pread({nbytes} B @ {offset}) on {st.path!r} "
                        f"failed after {attempt} attempt(s): {err}",
                        path=st.path, offset=offset, nbytes=nbytes,
                        attempts=attempt) from err
                raise ReadError(
                    f"pread({nbytes} B @ {offset}) on {st.path!r} kept "
                    f"coming back short ({len(data)}/{want} B) after "
                    f"{attempt} attempt(s)", path=st.path, offset=offset,
                    nbytes=nbytes, attempts=attempt)
            tainted = True
            with self._mu:
                st.stats.io_retries += 1
            time.sleep(policy.backoff(attempt - 1))

    def _refetch_page(self, st: _ServeState, pid: int, *,
                      deadline: float | None = None) -> bytes:
        """A page failed its CRC on cache fill: refetch it once; a second
        mismatch is a typed :class:`CorruptPageError`."""
        P = st.page_bytes
        with self._mu:
            st.stats.corrupt_pages += 1
        raw, dt, _ = self._pread_retry(st, P, pid * P, deadline=deadline)
        with self._mu:
            st.stats.record_read(len(raw), dt, tainted=True)
        if page_crc(raw, P) != st.page_crcs.get(pid):
            raise CorruptPageError(
                f"page {pid} of {st.path!r} failed CRC32 verification "
                f"twice", path=st.path, page_id=pid)
        return raw

    # -- descent ------------------------------------------------------------
    def _descend_prefix(self, st: _ServeState, q: np.ndarray):
        """Fused walk through the whole resident prefix → float64 (L, Q)
        lo/hi rows plus the backend that served ("cuda" or "numpy")."""
        if st.device_active:
            return fused_descent_with_backend(st.prefix, q, backend="cuda",
                                              module=st.fused)
        lo, hi = descend_layers(st.prefix, q)
        return lo, hi, "numpy"

    def _ensure_pages(self, st: _ServeState, page_ids: list,
                      deadline: float | None = None) -> dict:
        """All requested pages → bytes, via cache then coalesced preads."""
        P = st.page_bytes
        pages, missing = {}, []
        with self._mu:
            for pid in page_ids:
                data = st.cache.get(pid)
                if data is None:
                    missing.append(pid)
                else:
                    pages[pid] = data
                    st.stats.pages_hit += 1
                    st.stats.bytes_from_cache += len(data)
            if self.cache_profile is not None and pages:
                st.stats.modeled_seconds += len(pages) * float(
                    self.cache_profile(P))
        if missing:
            pages.update(self._fetch_missing(st, missing, deadline=deadline))
        return pages

    def _fetch_missing(self, st: _ServeState, missing: list, *,
                       overlapped: bool = False,
                       deadline: float | None = None) -> dict:
        """Coalesce missing page ids into runs and pread them into the
        cache.  A run that exhausts its retry budget is split and refetched
        page by page (each with a fresh budget) before the typed error
        surfaces; deadline expiry is not degradable and re-raises."""
        P = st.page_bytes
        pages = {}
        ms = np.asarray(missing, dtype=np.int64) * P
        run_s, run_e = coalesce_ranges(ms, ms + P, gap=self.coalesce_gap)
        for rs, re_ in zip(run_s, run_e):
            rs, re_ = int(rs), int(re_)
            try:
                got = self._fetch_run(st, rs, re_, overlapped=overlapped,
                                      deadline=deadline)
            except ReadError:
                with self._mu:
                    st.stats.degraded_runs += 1
                got = {}
                for po in range(rs, re_, P):
                    got.update(self._fetch_run(
                        st, po, min(po + P, re_), overlapped=overlapped,
                        deadline=deadline, tainted=True))
            pages.update(got)
        return pages

    def _fetch_run(self, st: _ServeState, rs: int, re_: int, *,
                   overlapped: bool = False,
                   deadline: float | None = None,
                   tainted: bool = False) -> dict:
        """One coalesced run → pages, through the retrying pread and (when
        the file carries checksums) per-page CRC32 verification before
        anything may enter the cache.  The pread runs outside the lock."""
        P = st.page_bytes
        raw, dt, tnt = self._pread_retry(st, re_ - rs, rs, deadline=deadline)
        tnt = tnt or tainted
        chunks = []
        for k in range(-(-len(raw) // P)):
            pid = rs // P + k
            chunk = raw[k * P:(k + 1) * P]
            if st.page_crcs is not None:
                crc = st.page_crcs.get(pid)
                if crc is not None and page_crc(chunk, P) != crc:
                    chunk = self._refetch_page(st, pid, deadline=deadline)
                    tnt = True
            chunks.append((pid, chunk))
        pages = {}
        with self._mu:
            st.stats.record_read(len(raw), dt, overlapped=overlapped,
                                 tainted=tnt)
            st.stats.preads += 1
            if overlapped:
                st.stats.overlapped_preads += 1
                st.stats.overlapped_pread_seconds += dt
            st.stats.bytes_fetched += len(raw)
            if self.profile is not None:
                t = float(self.profile(re_ - rs))
                st.stats.modeled_seconds += t
                st.stats.pread_modeled_seconds += t
            for pid, chunk in chunks:
                pages[pid] = chunk
                st.cache.put(pid, chunk)
                st.stats.pages_fetched += 1
        return pages

    def _descend_disk(self, st, lm, lo, hi, q: np.ndarray,
                      deadline: float | None = None):
        P = st.page_bytes
        a, b = record_aligned_range(lm.kind, lo, hi, lm.size)
        a, b = a.copy(), b.copy()       # per-query windows, grown on misses
        with self._mu:
            st.stats.ranges_requested += len(q)
            if self.profile is not None:  # full-price walk: one window/query
                st.stats.walk_modeled_seconds += float(
                    np.sum(self.profile((b - a).astype(np.float64))))
        out_lo = np.empty(len(q), dtype=np.float64)
        out_hi = np.empty(len(q), dtype=np.float64)
        pending = np.arange(len(q))
        while len(pending):
            ab, inv = np.unique(np.stack([a[pending], b[pending]], axis=1),
                                axis=0, return_inverse=True)
            inv = inv.reshape(-1)   # numpy 2.1 briefly returned (n, 1) here
            fa, fb = lm.offset + ab[:, 0], lm.offset + ab[:, 1]
            pa, pb = page_span(fa, fb - fa, P)      # elementwise over ranges
            need: set = set()
            for x, y in zip(pa.tolist(), pb.tolist()):
                need.update(range(x, y))
            pages = self._ensure_pages(st, sorted(need), deadline)
            still = []
            for ui in range(len(ab)):
                base = int(pa[ui]) * P
                buf = b"".join(pages[p]
                               for p in range(int(pa[ui]), int(pb[ui])))
                raw = buf[int(fa[ui]) - base:int(fb[ui]) - base]
                sub = pending[inv == ui]
                left, right = window_misses(lm.kind, raw, int(ab[ui, 0]),
                                            int(ab[ui, 1]), lm.size, q[sub])
                ok = sub[~(left | right)]
                if len(ok):
                    l_, h_ = predict_from_records(lm.kind, raw, q[ok],
                                                  lm.end_pos)
                    out_lo[ok] = l_
                    out_hi[ok] = h_
                # gallop the missed windows toward the covering record
                # (the same rule as SerializedIndex.lookup)
                w = gallop_step(lm.kind, int(ab[ui, 0]), int(ab[ui, 1]))
                lmiss, rmiss = sub[left], sub[right & ~left]
                a[lmiss] = max(int(ab[ui, 0]) - w, 0)
                b[rmiss] = min(int(ab[ui, 1]) + w, lm.size)
                still.extend([lmiss, rmiss])
                with self._mu:
                    st.stats.retries += len(lmiss) + len(rmiss)
                    if self.profile is not None \
                            and (len(lmiss) or len(rmiss)):
                        # the scalar walk re-reads each extended window
                        ext = np.concatenate([lmiss, rmiss])
                        st.stats.walk_modeled_seconds += float(np.sum(
                            self.profile(
                                (b[ext] - a[ext]).astype(np.float64))))
            pending = (np.concatenate(still) if still
                       else np.empty(0, dtype=np.int64))
        return out_lo, out_hi

    # -- public API ---------------------------------------------------------
    def lookup(self, queries) -> np.ndarray:
        """Batched Alg. 1 → (q, 2) int64 array of data-layer byte ranges.

        The resident prefix is descended in ONE fused dispatch (all layers,
        all queries); remaining layers walk the file through the block
        cache.  On the numpy backend the results are bit-identical to
        ``lookup_serialized`` on the same file; the cuda backend widens
        resident band layers by the f32 slack (ranges stay valid).  With
        ``spec.retry.batch_deadline_s`` set, every pread the batch
        triggers shares one absolute deadline.
        """
        st = self._pin()
        t0 = time.perf_counter()
        try:
            out = self._lookup_pinned(st, queries)
        finally:
            self._unpin(st)
        wall = time.perf_counter() - t0
        with self._mu:
            st.stats.record_lookup(len(out), wall)
        return out

    def _lookup_pinned(self, st: _ServeState, queries) -> np.ndarray:
        q = np.atleast_1d(np.asarray(queries, dtype=np.uint64))
        bdl = self.retry.batch_deadline_s
        deadline = (time.perf_counter() + bdl) if bdl is not None else None
        with self._mu:
            st.stats.queries += len(q)
            st.stats.batches += 1
        metas = st.meta.layers
        if len(q) == 0:
            return np.empty((0, 2), dtype=np.int64)
        if not metas:
            out = np.empty((len(q), 2), dtype=np.int64)
            out[:, 0] = 0
            out[:, 1] = st.meta.data_size
            if self.profile is not None:   # (no index): scan the data layer
                t = len(q) * float(self.profile(st.meta.data_size))
                with self._mu:
                    st.stats.data_modeled_seconds += t
                    st.stats.walk_modeled_seconds += t
            return out
        lo = hi = None
        n_res = len(st.prefix)
        if n_res:
            t0 = time.perf_counter()
            plo, phi, used = self._descend_prefix(st, q)
            dt = time.perf_counter() - t0
            walk = 0.0
            if self.profile is not None:
                for r, li in enumerate(st.prefix_lis):
                    lm = metas[li]
                    if r == 0:
                        # Alg. 1 reads the ROOT outright per query
                        walk += len(q) * float(self.profile(lm.size))
                    else:
                        # a non-root resident layer is a window read in
                        # the scalar walk: charge the record-aligned window
                        wa, wb = record_aligned_range(
                            lm.kind, plo[r - 1], phi[r - 1], lm.size)
                        walk += float(np.sum(
                            self.profile((wb - wa).astype(np.float64))))
            with self._mu:
                st.stats.descent_seconds += dt
                st.stats.walk_modeled_seconds += walk
                if used != "numpy":
                    st.stats.device_batches += 1
            lo, hi = plo[-1], phi[-1]
        for li in range(len(metas) - n_res - 1, -1, -1):
            lo, hi = self._descend_disk(st, metas[li], lo, hi, q, deadline)
        lo = np.maximum(np.asarray(lo, dtype=np.int64), 0)
        hi = np.minimum(np.maximum(np.asarray(hi, dtype=np.int64), lo + 1),
                        st.meta.data_size)
        if self.profile is not None:
            # the caller's final data-range read, modeled on the same tier
            t = float(np.sum(self.profile((hi - lo).astype(np.float64))))
            with self._mu:
                st.stats.data_modeled_seconds += t
                st.stats.walk_modeled_seconds += t
        return np.stack([lo, hi], axis=1)

    def lookup_batches(self, batches) -> list:
        """Serve a sequence of query batches through the two-stage
        pipeline: while this thread descends + walks batch *i*, a single
        background worker pre-issues the coalesced first-window preads of
        batches *i+1..i+depth*.  Returns one ``lookup``-shaped array per
        batch — identical to calling :meth:`lookup` sequentially
        (``spec.pipeline_depth == 0`` does exactly that).  A failure in the
        prefetch worker is re-raised here, at the next batch boundary."""
        batches = [np.atleast_1d(np.asarray(b, dtype=np.uint64))
                   for b in batches]
        depth = int(self.spec.pipeline_depth)
        if depth <= 0 or len(batches) <= 1:
            return [self.lookup(b) for b in batches]
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="airindex-prefetch")
        pending: dict[int, object] = {}
        out = []
        for i in range(len(batches)):
            for j in range(i + 1, min(i + depth, len(batches) - 1) + 1):
                if j not in pending:
                    pending[j] = self._executor.submit(
                        self._prefetch_task, batches[j])
            out.append(self.lookup(batches[i]))
            with self._mu:
                self.stats.pipelined_batches += 1
            fut = pending.pop(i + 1, None)
            if fut is not None:
                # batch i+1 is fully staged before stage 2 touches it,
                # which keeps the hit accounting deterministic
                fut.result()
            self._raise_prefetch_exc()
        for fut in pending.values():
            fut.result()
        self._raise_prefetch_exc()
        return out

    def _raise_prefetch_exc(self) -> None:
        """Surface the first exception the prefetch worker captured."""
        with self._mu:
            exc, self._prefetch_exc = self._prefetch_exc, None
        if exc is not None:
            raise exc

    def _prefetch_task(self, q: np.ndarray) -> int:
        """The worker's unit: pin an epoch, stage the batch, and capture
        any failure for the serving thread to re-raise."""
        try:
            st = self._pin()
        except RuntimeError:
            return 0                 # service closed under the pipeline
        try:
            return self._prefetch_batch(st, q)
        # airlint: allow[typed-error-flow] -- not absorbed: captured in
        # _prefetch_exc and re-raised typed at the next batch boundary
        except BaseException as e:   # noqa: BLE001 — re-raised on boundary
            with self._mu:
                if self._prefetch_exc is None:
                    self._prefetch_exc = e
            return 0
        finally:
            self._unpin(st)

    def _prefetch_batch(self, st: _ServeState, q: np.ndarray) -> int:
        """Stage 1 of the pipeline: descend the resident prefix for a
        future batch and pread its missing first-window pages into the
        cache (tagged ``overlapped``), up to ``spec.prefetch_layers`` disk
        layers deep through already-cached records only.  Returns the
        number of pages staged."""
        t_start = time.perf_counter()
        metas = st.meta.layers
        n_res = len(st.prefix)
        n_disk = len(metas) - n_res
        staged = 0
        if n_disk <= 0 or len(q) == 0:
            return 0
        if n_res:
            plo, phi, _ = self._descend_prefix(st, q)
            lo, hi = plo[-1], phi[-1]
        else:
            lo = hi = None
        depth = min(max(int(self.spec.prefetch_layers), 1), n_disk)
        P = st.page_bytes
        for d in range(depth):
            lm = metas[n_disk - 1 - d]
            a, b = record_aligned_range(lm.kind, lo, hi, lm.size)
            ab = np.unique(np.stack([a, b], axis=1), axis=0)
            fa, fb = lm.offset + ab[:, 0], lm.offset + ab[:, 1]
            pa, pb = page_span(fa, fb - fa, P)
            need: set = set()
            for x, y in zip(pa.tolist(), pb.tolist()):
                need.update(range(x, y))
            with self._mu:
                missing = [pid for pid in sorted(need)
                           if pid not in st.cache]
            if missing:
                staged += len(self._fetch_missing(st, missing,
                                                  overlapped=True))
            if d + 1 < depth:
                lo, hi, q = self._advance_windows(st, lm, a, b, q)
                if len(q) == 0:
                    break
        with self._mu:
            st.stats.prefetch_seconds += time.perf_counter() - t_start
        return staged

    def _advance_windows(self, st: _ServeState, lm, a, b, q: np.ndarray):
        """Predict the next layer's windows from *cached* pages only
        (``peek``: no promotion, no hit/miss skew).  Queries whose pages
        were evicted, or whose covering record lies outside the first
        window, drop out of the prefetch."""
        P = st.page_bytes
        ab, inv = np.unique(np.stack([a, b], axis=1), axis=0,
                            return_inverse=True)
        inv = inv.reshape(-1)
        fa, fb = lm.offset + ab[:, 0], lm.offset + ab[:, 1]
        pa, pb = page_span(fa, fb - fa, P)
        idx = np.arange(len(q))
        los, his, qs = [], [], []
        for ui in range(len(ab)):
            with self._mu:
                chunks = [st.cache.peek(p)
                          for p in range(int(pa[ui]), int(pb[ui]))]
            if any(c is None for c in chunks):
                continue            # evicted under pressure: stop here
            base = int(pa[ui]) * P
            raw = b"".join(chunks)[int(fa[ui]) - base:int(fb[ui]) - base]
            sub = idx[inv == ui]
            left, right = window_misses(lm.kind, raw, int(ab[ui, 0]),
                                        int(ab[ui, 1]), lm.size, q[sub])
            ok = sub[~(left | right)]
            if len(ok) == 0:
                continue
            l_, h_ = predict_from_records(lm.kind, raw, q[ok], lm.end_pos)
            los.append(l_)
            his.append(h_)
            qs.append(q[ok])
        if not qs:
            e = np.empty(0, dtype=np.float64)
            return e, e, np.empty(0, dtype=np.uint64)
        return (np.concatenate(los), np.concatenate(his),
                np.concatenate(qs))

    # -- the observe → retune loop -------------------------------------------
    @property
    def tune_spec(self):
        """The TuneSpec recorded in the file meta (or None)."""
        spec = (self.tune_meta or {}).get("spec")
        if spec is None:
            return None
        from repro_torch.api.spec import TuneSpec   # lazy: api sits above
        try:
            return TuneSpec.from_dict(spec)
        except (TypeError, ValueError):
            return None   # forward-version provenance: serve anyway

    def cached_profile(self, backing: StorageProfile | None = None) -> CachedProfile:
        """Effective ``T(Δ)`` at the observed hit rate — hand this back to
        the tuner to re-tune the index for this cache deployment."""
        backing = backing or self.profile
        if backing is None:
            raise ValueError("no backing profile: the service was opened "
                             "with profile=None — pass one explicitly")
        return CachedProfile(backing=backing, cache=self.cache_profile,
                             hit_rate=self.stats.hit_rate)

    def observed_profile(self, backing: StorageProfile | None = None, *,
                         measured: bool = True,
                         min_samples: int = MIN_FIT_SAMPLES,
                         distributional: bool = False) -> CachedProfile:
        """Effective ``T(Δ)`` from observed serving behavior: the hit rate
        plus (``measured=True``) the measured per-pread latency in place of
        the modeled backing tier.  With ``measured=False`` it equals
        :meth:`cached_profile`."""
        backing = backing or self.profile
        if backing is None:
            raise ValueError("no backing profile: the service was opened "
                             "with profile=None — pass one explicitly")
        return observed_profile_from_stats(self.stats, backing,
                                           self.cache_profile,
                                           measured=measured,
                                           min_samples=min_samples,
                                           distributional=distributional)

    def save_stats(self, *, window: int = STATS_WINDOW) -> str:
        """Persist the current :class:`ServeStats` snapshot next to the
        index meta (``<path>.stats.json``, rotating window) → its path."""
        prof = getattr(self.profile, "name", None)
        return save_stats_snapshot(self.path, self.stats,
                                   profile_name=prof, window=window)
