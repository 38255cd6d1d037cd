"""Synthetic key distributions mirroring the paper's datasets (§7.1): the
port's copy of the JAX package's ``repro.data.datasets``, numpy only.

books/fb/osm/wiki come from SOSD [42]; we generate distributions with the
same qualitative structure at container scale (the paper's are 200–800M
keys; the generators accept any n).  gmm follows the paper exactly: a
100-cluster Gaussian mixture.  wiki includes duplicate keys (the paper's
"unusual dataset"), deduplicated into first-offset semantics by the caller.
"""
from __future__ import annotations

import numpy as np


def _dedup_sorted(keys: np.ndarray) -> np.ndarray:
    return np.unique(keys)


def sosd_like(name: str, n: int, seed: int = 0) -> np.ndarray:
    """→ sorted unique uint64 keys.  The seed adds ``hash(name)``, which
    ``PYTHONHASHSEED`` changes between processes, as the JAX package's
    does: within one process both packages draw the same keys."""
    rng = np.random.default_rng(seed + hash(name) % 2**16)
    if name == "books":
        # heavy-tailed popularity counts accumulated (Amazon book sales)
        gaps = rng.zipf(1.31, int(n * 1.05)).astype(np.uint64)
        keys = np.cumsum(gaps)[:n]
    elif name == "fb":
        # Facebook user ids: dense near-linear ranges with rare big jumps
        base = rng.integers(1, 12, int(n * 1.05), dtype=np.uint64)
        jump = (rng.random(int(n * 1.05)) < 2e-5) * rng.integers(
            2**33, 2**35, int(n * 1.05), dtype=np.uint64)
        keys = np.cumsum(base + jump)[:n]
    elif name == "osm":
        # OSM cell ids: highly clustered, multi-scale (hardest in the paper)
        n_cl = max(int(np.sqrt(n)) // 4, 8)
        centers = np.sort(rng.integers(2**40, 2**62, n_cl, dtype=np.uint64))
        sizes = rng.zipf(1.4, n_cl).astype(np.float64)
        sizes = np.maximum(sizes / sizes.sum() * n, 1).astype(np.int64)
        parts = [c + rng.integers(0, max(int(s) * 64, 64), int(s),
                                  dtype=np.uint64)
                 for c, s in zip(centers, sizes)]
        keys = np.concatenate(parts)[:n]
    elif name == "wiki":
        # edit timestamps: near-uniform with many duplicates
        keys = np.sort(rng.integers(1, n * 8, int(n * 1.3),
                                    dtype=np.uint64))[:n]
    elif name == "gmm":
        # paper §7.1: Gaussian mixture, 100 clusters
        centers = rng.uniform(2**32, 2**52, 100)
        scales = rng.uniform(2**24, 2**30, 100)
        parts = [np.abs(rng.normal(c, s, n // 100 + 1)) for c, s in
                 zip(centers, scales)]
        keys = np.concatenate(parts)[:n].astype(np.uint64) + 1
    elif name == "uden64":
        keys = rng.integers(1, 2**63, int(n * 1.05), dtype=np.uint64)[:n]
    else:
        raise ValueError(name)
    return _dedup_sorted(np.sort(keys))


DATASETS = ("books", "fb", "osm", "wiki", "gmm")
