"""Storage performance profiles ``T(Δ)`` (paper §3.2).

``T(Δ)`` is the expected time to read ``Δ`` consecutive bytes from a storage
tier.  The paper implements the affine profile ``T_aff(Δ) = ℓ + Δ/B`` and
notes that the optimization works with *any* monotonically increasing
``T``.  Provided, as in the JAX package's ``repro.core.storage``:

  * :class:`AffineProfile`        — ``ℓ + Δ/B`` (paper default),
  * :class:`AffineUniformProfile` — expectation under uniformly varying
    latency/bandwidth (paper §3.2 closed form),
  * :class:`MeasuredProfile`      — monotone piecewise-linear interpolation
    of real measurements, plus :func:`profile_local_storage`, which
    measures the local filesystem,
  * :class:`DistributionalProfile` — per-Δ latency distributions (mean,
    mean-excess, empirical quantiles), the raw material of tail tuning,
  * :class:`ObjectiveProfile`     — the per-read cost curve that folds the
    ``E[T] + w·Q_p[T]`` objective into an additive ``C(Δ)``,
  * :class:`CachedProfile`        — ``T(Δ)`` seen through a block cache.

``PROFILES`` holds the paper's tiers, host DRAM (the block cache's hit
cost) and ``hbm``, the H100's device memory as measured there (the JAX
package's TPU tiers are not carried: their constants belong to another
machine).  Host-side numpy,
bit-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np


class StorageProfile:
    """Monotone non-decreasing expected read time ``T(Δ)`` in seconds."""

    name: str = "abstract"

    def read_time(self, delta):
        """Vectorized ``T(Δ)``; ``delta`` in bytes (scalar or ndarray)."""
        raise NotImplementedError

    def mean_excess(self, delta):
        """Per-read upper-tail mass ``E[(T(Δ) − E[T(Δ)])₊]`` in seconds.

        Zero for deterministic profiles (affine/measured constants model
        the *expected* time only); :class:`DistributionalProfile`
        overrides this with the fitted empirical excess.  This is the
        quantity the quantile objective propagates through a layer stack
        (see :class:`ObjectiveProfile`).
        """
        return np.asarray(delta, dtype=np.float64) * 0.0

    def __call__(self, delta):
        return self.read_time(delta)


@dataclasses.dataclass(frozen=True)
class AffineProfile(StorageProfile):
    """``T(Δ) = ℓ + Δ / B`` with latency ``ℓ`` [s] and bandwidth ``B`` [B/s]."""

    latency: float
    bandwidth: float
    name: str = "affine"

    def read_time(self, delta):
        return self.latency + np.asarray(delta, dtype=np.float64) / self.bandwidth


@dataclasses.dataclass(frozen=True)
class AffineUniformProfile(StorageProfile):
    """Affine profile with uniformly varying ``ℓ ∈ [ℓ0, ℓ1]``, ``B ∈ [B0, B1]``.

    Paper §3.2: ``T(Δ) = (ℓ0+ℓ1)/2 + Δ (ln B1 − ln B0)/(B1 − B0)``.
    """

    latency_lo: float
    latency_hi: float
    bandwidth_lo: float
    bandwidth_hi: float
    name: str = "affine-uniform"

    def coefficients(self) -> tuple[float, float]:
        """The closed-form ``(ℓ, 1/B)`` this profile is affine with —
        single source of truth for read_time and affine_coefficients."""
        ell = 0.5 * (self.latency_lo + self.latency_hi)
        if self.bandwidth_hi == self.bandwidth_lo:
            inv_bw = 1.0 / self.bandwidth_lo
        else:
            inv_bw = (np.log(self.bandwidth_hi) - np.log(self.bandwidth_lo)) / (
                self.bandwidth_hi - self.bandwidth_lo)
        return float(ell), float(inv_bw)

    def read_time(self, delta):
        ell, inv_bw = self.coefficients()
        return ell + np.asarray(delta, dtype=np.float64) * inv_bw


@dataclasses.dataclass(frozen=True)
class MeasuredProfile(StorageProfile):
    """Monotone piecewise-linear ``T(Δ)`` through measured (Δ, seconds) points."""

    deltas: tuple          # increasing byte sizes
    seconds: tuple         # measured expected read times
    name: str = "measured"

    def read_time(self, delta):
        d = np.asarray(delta, dtype=np.float64)
        xs = np.asarray(self.deltas, dtype=np.float64)
        ys = np.maximum.accumulate(np.asarray(self.seconds, dtype=np.float64))
        # extrapolate the last segment's slope beyond the measured range
        out = np.interp(d, xs, ys)
        slope = (ys[-1] - ys[-2]) / max(xs[-1] - xs[-2], 1.0) if len(xs) > 1 else 0.0
        out = np.where(d > xs[-1], ys[-1] + (d - xs[-1]) * slope, out)
        return out

    def fit_affine(self) -> AffineProfile:
        """Least-squares affine fit — useful to report ℓ and B of a tier.

        Degenerate measurements — fewer than 2 distinct Δ values (the
        normal equations are singular; lstsq's minimum-norm solution
        splits the constant arbitrarily between ℓ and the slope) or
        all-equal seconds (slope 0, or slightly negative from fp noise)
        — used to yield negative/NaN predicted latencies that poison
        batched candidate scoring.  Both shapes now degrade to a
        *constant* profile at the mean measured seconds, with a warning;
        a genuinely negative fitted slope is clamped the same way.
        """
        xs = np.asarray(self.deltas, dtype=np.float64)
        ys = np.asarray(self.seconds, dtype=np.float64)
        constant = AffineProfile(latency=max(float(np.mean(ys)), 1e-12),
                                 bandwidth=1e30,  # finite so JSON round-trips
                                 name=f"{self.name}-affine")
        if len(np.unique(xs)) < 2 or np.allclose(ys, ys[0]):
            warnings.warn(
                f"fit_affine({self.name}): degenerate measurements "
                "(<2 distinct sizes or constant seconds); using a "
                "constant profile", RuntimeWarning, stacklevel=2)
            return constant
        A = np.stack([np.ones_like(xs), xs], axis=1)
        (ell, inv_bw), *_ = np.linalg.lstsq(A, ys, rcond=None)
        ell, inv_bw = float(ell), float(inv_bw)
        if not (np.isfinite(ell) and np.isfinite(inv_bw)) or inv_bw <= 0.0:
            warnings.warn(
                f"fit_affine({self.name}): non-finite or non-positive "
                f"slope ({inv_bw!r}); using a constant profile",
                RuntimeWarning, stacklevel=2)
            return constant
        ell = max(ell, 1e-12)
        bw = 1.0 / inv_bw
        return AffineProfile(latency=ell, bandwidth=bw, name=f"{self.name}-affine")


@dataclasses.dataclass(frozen=True)
class DistributionalProfile(StorageProfile):
    """Per-Δ latency *distributions* fitted from observed preads.

    Beyond the monotone mean curve of :class:`MeasuredProfile`, each
    measured size carries the empirical upper-tail mass
    ``me(Δ) = E[(T − E[T])₊]`` and a grid of empirical quantiles.  The
    mean and mean-excess curves are what the quantile tuning objective
    consumes (:class:`ObjectiveProfile`); the quantile grid is for
    reporting (``quantile_time``).

    Both curves are made monotone in Δ by a running max — conservative
    when a larger read happens to be better-behaved than a smaller one,
    but required by the search's monotone-``T`` assumption.  Beyond the
    measured range the mean extrapolates the last segment's slope
    (bandwidth keeps costing) while the excess holds flat (a stall does
    not grow with the read size it interrupted).
    """

    deltas: tuple          # increasing byte sizes
    means: tuple           # per-Δ mean seconds
    excess: tuple          # per-Δ E[(T − mean)₊] seconds
    qs: tuple = ()         # quantile grid in (0, 1], increasing
    qvalues: tuple = ()    # per-Δ tuple of quantile seconds, len == len(qs)
    name: str = "distributional"

    def _curve(self, delta, raw, *, extrapolate_slope):
        d = np.asarray(delta, dtype=np.float64)
        xs = np.asarray(self.deltas, dtype=np.float64)
        ys = np.maximum.accumulate(np.asarray(raw, dtype=np.float64))
        out = np.interp(d, xs, ys)
        if extrapolate_slope and len(xs) > 1:
            slope = (ys[-1] - ys[-2]) / max(xs[-1] - xs[-2], 1.0)
            out = np.where(d > xs[-1], ys[-1] + (d - xs[-1]) * slope, out)
        return out

    def read_time(self, delta):
        return self._curve(delta, self.means, extrapolate_slope=True)

    def mean_excess(self, delta):
        return np.maximum(
            self._curve(delta, self.excess, extrapolate_slope=False), 0.0)

    def quantile_time(self, delta, p):
        """Empirical per-read ``p``-quantile of ``T(Δ)`` (reporting only —
        the tuning objective propagates ``mean_excess``, not this)."""
        if not self.qs:
            return self.read_time(delta)
        qs = np.asarray(self.qs, dtype=np.float64)
        rows = np.asarray(self.qvalues, dtype=np.float64)  # (n_deltas, n_qs)
        p = min(max(float(p), float(qs[0])), float(qs[-1]))
        per_delta = np.array([np.interp(p, qs, row) for row in rows])
        return self._curve(delta, per_delta, extrapolate_slope=True)

    @classmethod
    def fit(cls, samples, *, min_samples: int = 32, min_sizes: int = 2,
            qs=(0.5, 0.9, 0.95, 0.99),
            name: str = "distributional") -> "DistributionalProfile | None":
        """Fit from ``(Δ, seconds)`` pairs; ``None`` when too scarce.

        Requires ``min_samples`` total observations over at least
        ``min_sizes`` distinct sizes — the same contract as the measured
        mean fit, so a scarce reservoir degrades to "no observed
        profile" rather than a one-point distribution.
        """
        pairs = [(float(d), float(s)) for d, s in samples]
        if len(pairs) < min_samples:
            return None
        arr = np.asarray(pairs, dtype=np.float64)
        uniq = np.unique(arr[:, 0])
        if len(uniq) < min_sizes:
            return None
        means, excess, qvals = [], [], []
        for d in uniq:
            ts = arr[arr[:, 0] == d, 1]
            mu = float(ts.mean())
            means.append(mu)
            excess.append(float(np.maximum(ts - mu, 0.0).mean()))
            qvals.append(tuple(float(np.quantile(ts, q)) for q in qs))
        return cls(deltas=tuple(float(d) for d in uniq), means=tuple(means),
                   excess=tuple(excess), qs=tuple(float(q) for q in qs),
                   qvalues=tuple(qvals), name=name)


@dataclasses.dataclass(frozen=True)
class ObjectiveProfile(StorageProfile):
    """Per-read cost curve of the tail objective ``E[T] + w·Q_p[T]``.

    A lookup's latency is a sum of pread times, ``T = Σ Tᵢ``.  Writing
    ``μᵢ = E[Tᵢ]``, Markov's inequality on the summed positive excess
    gives, for any dependence structure,

        ``Q_p[T] ≤ Σ μᵢ + (Σ E[(Tᵢ − μᵢ)₊]) / (1 − p)``

    and under the documented *independent-pread approximation* this is
    the single-big-jump estimate of the tail (tight for the
    subexponential stall-dominated distributions the fault layer
    produces: a bad lookup is one stalled pread, and stall probability
    accumulates linearly across the stack).  The objective therefore
    decomposes into an additive per-read cost

        ``C(Δ) = (1 + w)·μ(Δ) + (w / (1 − p))·me(Δ)``

    which is exactly this profile's ``read_time``.  Every mean-latency
    search (Eq. 6's additive recursion, the fused sweep's batched
    scoring, ``tau_hat``'s ranking) ranks designs by the tail objective
    simply by receiving this profile instead of the base one.  With a
    deterministic base (``me ≡ 0``) the curve is ``(1 + w)·μ`` — same
    argmin as the mean objective, cost scaled by exactly ``1 + w``.
    """

    base: StorageProfile
    p: float
    weight: float
    name: str = "objective"

    def read_time(self, delta):
        mu = np.asarray(self.base.read_time(delta), dtype=np.float64)
        me = np.asarray(self.base.mean_excess(delta), dtype=np.float64)
        return (1.0 + self.weight) * mu + (self.weight / (1.0 - self.p)) * me

    def mean_excess(self, delta):
        # the synthetic curve is itself a deterministic cost model
        return np.asarray(delta, dtype=np.float64) * 0.0


def normalize_objective(objective) -> tuple[float, float] | None:
    """``None`` for the mean objective, else a validated ``(p, weight)``.

    Accepts ``None`` / ``"mean"`` / ``{"p": q, "weight": w}`` (weight
    defaults to 1.0; ``weight == 0`` *is* the mean objective).  Raises
    ``ValueError`` on anything else — objectives are user-facing spec
    fields and silent fallback would tune for the wrong thing.
    """
    if objective is None or objective == "mean":
        return None
    if isinstance(objective, dict):
        extra = set(objective) - {"p", "weight"}
        if extra:
            raise ValueError(f"objective: unknown keys {sorted(extra)}")
        try:
            p = float(objective["p"])
            w = float(objective.get("weight", 1.0))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"objective: need numeric 'p' (got {objective!r})") from e
        if not 0.0 < p < 1.0:
            raise ValueError(f"objective: p must be in (0, 1), got {p}")
        if not w >= 0.0:
            raise ValueError(f"objective: weight must be >= 0, got {w}")
        return None if w == 0.0 else (p, w)
    raise ValueError(f"objective must be 'mean' or a {{p, weight}} dict, "
                     f"got {objective!r}")


def objective_profile(profile: StorageProfile, objective) -> StorageProfile:
    """Wrap ``profile`` for the requested objective.

    The mean objective returns ``profile`` itself (same object — the
    guarantee behind ``objective="mean"`` being bit-identical to the
    pre-objective search); a quantile objective returns the
    :class:`ObjectiveProfile` cost curve over it.
    """
    norm = normalize_objective(objective)
    if norm is None:
        return profile
    p, w = norm
    return ObjectiveProfile(base=profile, p=p, weight=w,
                            name=f"{profile.name}|p{p:g}w{w:g}")


#: CachedProfile's default cache tier (host-DRAM constants; also the
#: basis of PROFILES["host_dram"] below)
_DEFAULT_CACHE = AffineProfile(150e-9, 50e9, name="host_dram")


@dataclasses.dataclass(frozen=True)
class CachedProfile(StorageProfile):
    """``T(Δ)`` seen *through* a block cache in front of a backing tier.

    A fraction ``hit_rate`` of reads is served by the cache tier (DRAM by
    default), the rest by the backing tier:

        ``T(Δ) = h · T_cache(Δ) + (1 − h) · T_backing(Δ)``

    Monotone whenever both component profiles are, so AirTune can tune an
    index *for* a cached deployment unchanged — with a hot cache the
    effective tier is fat-and-fast and the optimum shifts toward fewer,
    larger layers (paper Fig. 1 intuition).  A serving engine's observed
    hit rate closes the loop: serve → measure → re-tune.
    """

    backing: StorageProfile
    cache: StorageProfile | None = None   # default: host-DRAM constants
    hit_rate: float = 0.0
    name: str = "cached"

    def read_time(self, delta):
        h = min(max(float(self.hit_rate), 0.0), 1.0)
        cache = self.cache or _DEFAULT_CACHE
        return (h * np.asarray(cache(delta), dtype=np.float64)
                + (1.0 - h) * np.asarray(self.backing(delta), dtype=np.float64))

    def mean_excess(self, delta):
        # hit-rate blend of the component tails, mirroring read_time
        h = min(max(float(self.hit_rate), 0.0), 1.0)
        cache = self.cache or _DEFAULT_CACHE
        return (h * np.asarray(cache.mean_excess(delta), dtype=np.float64)
                + (1.0 - h) * np.asarray(self.backing.mean_excess(delta),
                                         dtype=np.float64))


def profile_local_storage(path: str, *, sizes=None, repeats: int = 5,
                          file_bytes: int = 1 << 26, rng=None) -> MeasuredProfile:
    """Measure ``T(Δ)`` of the filesystem hosting ``path`` (paper §3.2).

    Writes a scratch file once, then times ``pread``s of each size at random
    offsets.  Page-cache effects make this a *warm* profile on this
    container; it is still monotone and exercises the real syscall path.
    """
    if sizes is None:
        sizes = [1 << s for s in range(8, 23, 2)]  # 256 B .. 4 MiB
    rng = rng or np.random.default_rng(0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not os.path.exists(path) or os.path.getsize(path) < file_bytes:
        with open(path, "wb") as f:
            f.write(os.urandom(min(file_bytes, 1 << 26)))
    # airlint: allow[pread-seam] -- §3.2 probe: measures the raw syscall
    # path on purpose; wrapping it in a backend would time the wrapper
    fd = os.open(path, os.O_RDONLY)
    try:
        actual = os.path.getsize(path)
        meas = []
        for sz in sizes:
            ts = []
            for _ in range(repeats):
                off = int(rng.integers(0, max(actual - sz, 1)))
                t0 = time.perf_counter()
                # airlint: allow[pread-seam] -- the probe's measured read:
                # timing the bare syscall IS the point (§3.2 profiling)
                os.pread(fd, sz, off)
                ts.append(time.perf_counter() - t0)
            meas.append(float(np.median(ts)))
        return MeasuredProfile(deltas=tuple(sizes), seconds=tuple(meas), name="local-fs")
    finally:
        os.close(fd)


def affine_coefficients(profile: StorageProfile) -> tuple[float, float] | None:
    """``(ℓ, 1/B)`` if ``T(Δ) = ℓ + Δ·(1/B)`` holds exactly, else None.

    The device-side batched candidate scorer
    (:mod:`repro_torch.kernels.candidate_score`) evaluates only affine-
    representable tiers in closed form; any other profile takes the numpy
    path.  ``AffineUniformProfile`` and ``CachedProfile`` over affine
    components are affine in Δ and are folded here.
    """
    if isinstance(profile, AffineProfile):
        return float(profile.latency), 1.0 / float(profile.bandwidth)
    if isinstance(profile, AffineUniformProfile):
        return profile.coefficients()
    if isinstance(profile, CachedProfile):
        cache = profile.cache or _DEFAULT_CACHE
        back = affine_coefficients(profile.backing)
        front = affine_coefficients(cache)
        if back is None or front is None:
            return None
        h = min(max(float(profile.hit_rate), 0.0), 1.0)
        return (h * front[0] + (1.0 - h) * back[0],
                h * front[1] + (1.0 - h) * back[1])
    if isinstance(profile, ObjectiveProfile):
        # affine-representable bases are deterministic (mean_excess ≡ 0),
        # so the objective curve is the base scaled by (1 + w)
        base = affine_coefficients(profile.base)
        if base is None:
            return None
        scale = 1.0 + float(profile.weight)
        return scale * base[0], scale * base[1]
    return None


# ---------------------------------------------------------------------------
# JSON round-trip for profiles (provenance: an index file records the T(Δ)
# it was tuned for, so measured/custom tiers can be restored — not just
# named constants).  Unknown profile types degrade to None rather than
# failing the save/open.  The dicts are the JAX package's, key for key.
# ---------------------------------------------------------------------------
def profile_to_dict(profile: StorageProfile | None) -> dict | None:
    if isinstance(profile, AffineProfile):
        return {"kind": "affine", "latency": profile.latency,
                "bandwidth": profile.bandwidth, "name": profile.name}
    if isinstance(profile, AffineUniformProfile):
        return {"kind": "affine_uniform",
                "latency_lo": profile.latency_lo,
                "latency_hi": profile.latency_hi,
                "bandwidth_lo": profile.bandwidth_lo,
                "bandwidth_hi": profile.bandwidth_hi, "name": profile.name}
    if isinstance(profile, MeasuredProfile):
        return {"kind": "measured", "deltas": list(profile.deltas),
                "seconds": list(profile.seconds), "name": profile.name}
    if isinstance(profile, DistributionalProfile):
        return {"kind": "distributional", "deltas": list(profile.deltas),
                "means": list(profile.means), "excess": list(profile.excess),
                "qs": list(profile.qs),
                "qvalues": [list(row) for row in profile.qvalues],
                "name": profile.name}
    if isinstance(profile, ObjectiveProfile):
        base = profile_to_dict(profile.base)
        if base is None:
            return None
        return {"kind": "objective", "base": base, "p": profile.p,
                "weight": profile.weight, "name": profile.name}
    if isinstance(profile, CachedProfile):
        backing = profile_to_dict(profile.backing)
        if backing is None:
            return None
        return {"kind": "cached", "backing": backing,
                "cache": profile_to_dict(profile.cache),
                "hit_rate": profile.hit_rate, "name": profile.name}
    return None


def profile_from_dict(d: dict | None) -> StorageProfile | None:
    if not isinstance(d, dict):
        return None
    try:
        kind = d["kind"]
        if kind == "affine":
            return AffineProfile(d["latency"], d["bandwidth"],
                                 name=d.get("name", "affine"))
        if kind == "affine_uniform":
            return AffineUniformProfile(
                d["latency_lo"], d["latency_hi"],
                d["bandwidth_lo"], d["bandwidth_hi"],
                name=d.get("name", "affine-uniform"))
        if kind == "measured":
            return MeasuredProfile(tuple(d["deltas"]), tuple(d["seconds"]),
                                   name=d.get("name", "measured"))
        if kind == "distributional":
            return DistributionalProfile(
                deltas=tuple(d["deltas"]), means=tuple(d["means"]),
                excess=tuple(d["excess"]), qs=tuple(d.get("qs", ())),
                qvalues=tuple(tuple(row) for row in d.get("qvalues", ())),
                name=d.get("name", "distributional"))
        if kind == "objective":
            base = profile_from_dict(d["base"])
            if base is None:
                return None
            return ObjectiveProfile(base=base, p=float(d["p"]),
                                    weight=float(d["weight"]),
                                    name=d.get("name", "objective"))
        if kind == "cached":
            backing = profile_from_dict(d["backing"])
            if backing is None:
                return None
            return CachedProfile(backing=backing,
                                 cache=profile_from_dict(d.get("cache")),
                                 hit_rate=d.get("hit_rate", 0.0),
                                 name=d.get("name", "cached"))
    except (KeyError, TypeError, ValueError):
        return None
    return None


HBM_LATENCY_S = 2.048e-6
HBM_BYTES_PER_S = 1.492874e12

PROFILES = {
    # paper §2.1 worked example
    "ssd_ex":    AffineProfile(100e-6, 1e9,    name="ssd_ex"),     # 100 µs, 1 GB/s
    "cloud_ex":  AffineProfile(100e-3, 100e6,  name="cloud_ex"),   # 100 ms, 100 MB/s
    # paper §7 experimental tiers (Fig. 3 / Fig. 14 constants)
    "azure_ssd": AffineProfile(250e-6, 175e6,  name="azure_ssd"),  # 250 µs, 175 MB/s
    "azure_nfs": AffineProfile(50e-3,  12e6,   name="azure_nfs"),  # 50 ms, 12 MB/s
    "azure_hdd": AffineProfile(2e-3,   60e6,   name="azure_hdd"),  # 500 IOPS, 60 MB/s
    # host DRAM: the block cache's hit cost
    "host_dram": _DEFAULT_CACHE,
    # the JAX package's named tiers, carried verbatim: constants that files
    # and specs may name, not measurements of the port
    "object_store": AffineProfile(80e-3, 250e6, name="object_store"),
    "hbm":          AffineProfile(1e-6,  819e9, name="hbm"),
    "vmem":         AffineProfile(30e-9, 10e12, name="vmem"),
    "ici":          AffineProfile(1e-6,  50e9,  name="ici"),
    "dcn":          AffineProfile(20e-6, 12.5e9, name="dcn"),
    # the card's memory, for page tables kept on the device: ℓ is the
    # device time per 4 KiB device-to-device copy of 200 queued back to
    # back, B the bytes copied per second by 2 GiB copies, both from CUDA
    # events in chip_smoke.py's measure_hbm on an NVIDIA H100 80GB HBM3 at
    # a 700 W power limit
    "h100_hbm": AffineProfile(HBM_LATENCY_S, HBM_BYTES_PER_S,
                              name="h100_hbm"),
}
