"""Key-position collections (the paper's ``D``).

A key-position collection ``D = {(x_i, y_i)}`` maps sorted 64-bit keys to
byte ranges ``y_i = [y^-_i, y^+_i)`` on storage (paper §4.1).  Every index
layer is built on top of such a collection, and building a layer produces a
new, smaller collection (its *outline*, Alg. 2 line 5).

Each pair also carries a *weight*: the number of original query keys it
covers, so the Eq. 6 expectation over the query-key distribution stays
exact after a layer is outlined into coarser pairs.

Host-side numpy, as in the JAX package (``repro.core.keyset``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

KEY_DTYPE = np.uint64
POS_DTYPE = np.int64  # byte offsets; int64 simplifies arithmetic, 2^63 B is plenty


@dataclasses.dataclass(frozen=True)
class KeyPositions:
    """Sorted keys with their byte ranges ``[lo, hi)`` and query weights."""

    keys: np.ndarray     # (n,) uint64, strictly increasing
    lo: np.ndarray       # (n,) int64, y^-
    hi: np.ndarray       # (n,) int64, y^+ ; contiguous data has hi[i] == lo[i+1]
    weights: np.ndarray  # (n,) float64, #original keys represented by each pair

    def __post_init__(self):
        n = len(self.keys)
        assert self.lo.shape == (n,) and self.hi.shape == (n,)
        assert self.weights.shape == (n,)
        object.__setattr__(self, "_f64_cache", {})

    def _f64(self, name: str) -> np.ndarray:
        """Cached float64 view: builders convert these arrays many times."""
        c = self._f64_cache
        if name not in c:
            c[name] = getattr(self, name).astype(np.float64)
        return c[name]

    @property
    def keys_f(self):
        return self._f64("keys")

    @property
    def lo_f(self):
        return self._f64("lo")

    @property
    def hi_f(self):
        return self._f64("hi")

    @property
    def mid_f(self):
        c = self._f64_cache
        if "mid" not in c:
            c["mid"] = 0.5 * (self.lo_f + self.hi_f)
        return c["mid"]

    @property
    def fingerprint(self) -> bytes:
        """Content digest of (keys, lo, hi, weights)."""
        c = self._f64_cache
        if "fingerprint" not in c:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(self.n).tobytes())
            for a in (self.keys, self.lo, self.hi, self.weights):
                h.update(np.ascontiguousarray(a).tobytes())
            c["fingerprint"] = h.digest()
        return c["fingerprint"]

    @property
    def n(self) -> int:
        return len(self.keys)

    @property
    def size_bytes(self) -> int:
        """Total extent ``s_D = y^+_n - y^-_1`` (paper §A.3)."""
        if self.n == 0:
            return 0
        return int(self.hi[-1] - self.lo[0])

    @property
    def total_weight(self) -> float:
        return float(self.weights.sum())

    @staticmethod
    def from_offsets(keys: np.ndarray, offsets: np.ndarray) -> "KeyPositions":
        """Build from record offsets: record i occupies [offsets[i], offsets[i+1])."""
        keys = np.asarray(keys, dtype=KEY_DTYPE)
        offsets = np.asarray(offsets, dtype=POS_DTYPE)
        assert len(offsets) == len(keys) + 1
        return KeyPositions(
            keys=keys,
            lo=offsets[:-1].copy(),
            hi=offsets[1:].copy(),
            weights=np.ones(len(keys), dtype=np.float64),
        )

    @staticmethod
    def fixed_record(keys: np.ndarray, record_bytes: int, base: int = 0) -> "KeyPositions":
        """Fixed-size records laid out consecutively from ``base``."""
        keys = np.asarray(keys, dtype=KEY_DTYPE)
        offs = base + record_bytes * np.arange(len(keys) + 1, dtype=POS_DTYPE)
        return KeyPositions.from_offsets(keys, offs)

    def validate(self) -> None:
        """Invariants used throughout: sorted unique keys, sane ranges."""
        if self.n == 0:
            return
        assert np.all(np.diff(self.keys.astype(np.uint64)) > 0), "keys must be strictly increasing"
        assert np.all(self.hi > self.lo), "empty position ranges"
        assert np.all(self.lo[1:] >= self.lo[:-1]), "positions must be non-decreasing"
        assert np.all(self.weights > 0)

    def slice(self, start: int, stop: int) -> "KeyPositions":
        return KeyPositions(
            keys=self.keys[start:stop], lo=self.lo[start:stop],
            hi=self.hi[start:stop], weights=self.weights[start:stop],
        )
