"""Per-layer descent primitives shared by every lookup path (Alg. 1 line 3–5).

One traversal step finds the covering piece/node for each query key, then
evaluates its prediction.  The same two vectorized functions back the
partial-read file traversal (:mod:`repro_torch.core.serialize`) and the
serving engine (:mod:`repro_torch.serve.index_service`), so on-disk and
served predictions agree bit for bit: the band midpoint is evaluated with
the identical float64 expression everywhere.

Also here: :func:`coalesce_ranges`, the batched-read planner — overlapping
or near-adjacent byte ranges requested by one query batch are merged into
maximal runs before any ``pread`` is issued.

Host-side numpy, as in the JAX package (``repro.core.descent``); the
float64 walk is the bit-exactness reference for the fused device descent.
"""
from __future__ import annotations

import numpy as np


def covering_index(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Rightmost i with ``sorted_keys[i] <= q`` per query, clipped to range."""
    idx = np.searchsorted(sorted_keys, queries, side="right") - 1
    return np.clip(idx, 0, len(sorted_keys) - 1)


def descend_step_layer(piece_keys: np.ndarray, pos_lo: np.ndarray,
                       pos_hi: np.ndarray,
                       queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One step-layer descent: piece ``i`` covering each query predicts
    ``[pos_lo[i], pos_hi[i])``.  All arrays vectorized over queries."""
    i = covering_index(piece_keys, queries)
    return pos_lo[i], pos_hi[i]


def descend_band_layer(node_keys: np.ndarray, x1: np.ndarray, y1: np.ndarray,
                       m: np.ndarray, delta: np.ndarray,
                       queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One band-layer descent → unclamped integer ``[⌊mid−δ⌋, ⌈mid+δ⌉)``.

    ``mid`` is evaluated in node-local float64 coordinates (``q − x1``) —
    the exact expression used at fit time; callers apply their own clamps.
    """
    j = covering_index(node_keys, queries)
    dx = (queries - x1[j]).astype(np.float64)
    mid = y1[j].astype(np.float64) + np.asarray(m)[j] * dx
    d = np.asarray(delta)[j]
    return np.floor(mid - d), np.ceil(mid + d)


def descend_layers(layers, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walk ``queries`` through a resident layer prefix, top-down.

    ``layers`` is a top-down sequence of parsed layer dicts (the
    :class:`repro_torch.serve.IndexService` resident representation)::

        {"kind": "step", "keys", "pos_lo", "pos_hi"}
        {"kind": "band", "x1", "y1", "m", "delta"}

    Returns ``(lo, hi)`` float64 arrays of shape ``(L, Q)``: row ``l`` is
    layer ``l``'s prediction for every query.  Each layer covers the full
    key domain, so rows are functions of the query key alone — which is
    what lets the fused descent kernel evaluate the whole prefix in one
    launch.  Row ``L-1`` is the window the on-disk walk continues from.
    """
    Q = len(queries)
    lo = np.empty((len(layers), Q), dtype=np.float64)
    hi = np.empty((len(layers), Q), dtype=np.float64)
    for li, lay in enumerate(layers):
        if lay["kind"] == "step":
            l_, h_ = descend_step_layer(lay["keys"], lay["pos_lo"],
                                        lay["pos_hi"], queries)
        else:
            l_, h_ = descend_band_layer(lay["x1"], lay["x1"], lay["y1"],
                                        lay["m"], lay["delta"], queries)
        lo[li], hi[li] = l_, h_
    return lo, hi


def coalesce_ranges(starts, ends, gap: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Merge byte ranges ``[starts[i], ends[i])`` that overlap or sit within
    ``gap`` bytes of each other into maximal runs, sorted ascending.

    ``gap > 0`` trades a few wasted bytes for fewer storage round-trips —
    profitable whenever ``T(gap) − T(0) < ℓ`` on the target tier.
    """
    s = np.asarray(starts, dtype=np.int64)
    e = np.asarray(ends, dtype=np.int64)
    if len(s) == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)              # furthest byte seen so far
    new_run = np.empty(len(s), dtype=bool)
    new_run[0] = True
    new_run[1:] = s[1:] > reach[:-1] + gap
    first = np.flatnonzero(new_run)
    run_starts = s[first]
    run_ends = np.maximum.reduceat(e, first)
    return run_starts, run_ends
