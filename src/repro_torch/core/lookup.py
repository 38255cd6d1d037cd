"""Query process (paper §4.2, Alg. 1) — batched, array-oriented, float64.

Each layer descent is a vectorized piece/node search plus a prediction
over a whole batch of query keys; the device version of the same walk is
:func:`repro_torch.kernels.index_lookup.traverse_index`.  This module
provides:

  * :func:`descend_step_layer` / :func:`descend_band_layer` — one layer of
    descent (re-exported from :mod:`repro_torch.core.descent`);
  * :func:`lookup_batch` — in-memory traversal returning predicted data
    ranges + the modeled per-query latency (Eq. 5 terms);
  * :func:`verify_lookup` and :func:`last_mile_search`;
  * :func:`lookup_file` — deprecation shim onto the facade.

Bit-identical to the JAX package's ``repro.core.lookup``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .descent import (coalesce_ranges, descend_band_layer,  # noqa: F401
                      descend_step_layer)
from .latency import IndexDesign
from .storage import StorageProfile


@dataclasses.dataclass(frozen=True)
class LookupResult:
    lo: np.ndarray            # (q,) predicted data-layer range start
    hi: np.ndarray            # (q,) predicted data-layer range end
    modeled_seconds: np.ndarray  # (q,) Σ T(Δ) + T(s_root) per query (Eq. 5)
    bytes_read: np.ndarray    # (q,) total bytes fetched per query


def lookup_batch(design: IndexDesign, queries: np.ndarray,
                 profile: StorageProfile | None = None) -> LookupResult:
    """Traverse the index top-down for a batch of keys (Alg. 1).

    Returns the final data-layer byte range per query; the caller fetches
    those ranges and runs the last-mile search (binary search over records).
    """
    q = np.asarray(queries, dtype=np.uint64)
    n_q = len(q)
    seconds = np.zeros(n_q, dtype=np.float64)
    nbytes = np.zeros(n_q, dtype=np.float64)
    if design.n_layers == 0:
        lo = np.full(n_q, design.data.lo[0], dtype=np.int64)
        hi = np.full(n_q, design.data.hi[-1], dtype=np.int64)
        width = float(design.data.size_bytes)
        if profile is not None:
            seconds += float(profile(width))
        return LookupResult(lo, hi, seconds, nbytes + width)

    # root layer: read in full
    root = design.layers[-1]
    root_size = float(root.size_bytes)
    nbytes += root_size
    if profile is not None:
        seconds += float(profile(root_size))

    lo = hi = None
    for layer in reversed(design.layers):
        lo, hi = layer.predict(q)
        width = (hi - lo).astype(np.float64)
        nbytes += width
        if profile is not None:
            seconds += np.asarray(profile(width), dtype=np.float64)
    return LookupResult(lo, hi, seconds, nbytes)


def verify_lookup(design: IndexDesign, queries: np.ndarray) -> bool:
    """Check validity end-to-end: the predicted final range must contain the
    true record range of every queried key (Eq. 1 composed across layers)."""
    D = design.data
    idx = np.searchsorted(D.keys, np.asarray(queries, dtype=np.uint64))
    idx = np.clip(idx, 0, D.n - 1)
    res = lookup_batch(design, queries)
    ok = (res.lo <= D.lo[idx]) & (res.hi >= D.hi[idx])
    return bool(np.all(ok))


def last_mile_search(keys_in_range: np.ndarray, query: int) -> int:
    """Binary search within a fetched data range (Alg. 1 line 3)."""
    i = int(np.searchsorted(keys_in_range, np.uint64(query), side="right")) - 1
    return max(i, 0)


def lookup_file(path: str, design_meta, queries: np.ndarray):
    """Deprecated shim: use ``repro_torch.api.Index.open(path).lookup(
    queries)``, the identical :class:`repro_torch.core.serialize.
    SerializedIndex` walk, so results are bit-identical.  ``design_meta``
    was always unused and is ignored."""
    from .deprecation import warn_deprecated
    warn_deprecated(
        "repro_torch.core.lookup.lookup_file(path, meta, queries) is "
        "deprecated; use repro_torch.api.Index.open(path).lookup(queries)")
    from repro_torch.api import Index
    with Index.open(path) as idx:
        return idx.lookup(queries)
