"""Step index complexity ``τ̂(D; T)`` (paper §5.3, §A.3, Eq. 12).

The optimal remaining lookup cost of indexing a collection of extent
``s_D`` with *ideal balanced step layers* only:

    τ̂(D; T) = min_{L ∈ 0..O(log s_D)} (L+1) · T( (s_D · s_step^L)^(1/(L+1)) )

where ``s_step`` is the size of a 1-piece step node (16 B for 8-byte keys
and positions).  It upper-bounds the true index complexity ``τ(D; T)`` and
depends only on the integer ``s_D`` — hence arithmetically computable and
cheap — making it the "remaining work" heuristic for AirTune's top-k
candidate selection (Eq. 9).
"""
from __future__ import annotations

import numpy as np

from .keyset import KeyPositions
from .storage import StorageProfile

S_STEP = 16.0  # bytes of an ideal 1-piece step node (8 B key + 8 B position)


def step_index_complexity(size_bytes: float, profile: StorageProfile,
                          max_layers: int | None = None) -> float:
    """Eq. (12) — vectorized over candidate layer counts L."""
    s = max(float(size_bytes), 1.0)
    if max_layers is None:
        # L beyond log_{?}(s_D) cannot help; log2 is a safe upper bound
        max_layers = int(np.ceil(np.log2(max(s, 2.0)))) + 1
    L = np.arange(0, max_layers + 1, dtype=np.float64)
    # (s_D * s_step^L)^(1/(L+1)) computed in log space for stability
    log_read = (np.log(s) + L * np.log(S_STEP)) / (L + 1.0)
    reads = np.exp(log_read)
    costs = (L + 1.0) * np.asarray(profile(reads), dtype=np.float64)
    return float(costs.min())


def step_index_complexity_layers(size_bytes: float, profile: StorageProfile) -> int:
    """The arg-min L of Eq. (12) — the depth an ideal step index would use."""
    s = max(float(size_bytes), 1.0)
    max_layers = int(np.ceil(np.log2(max(s, 2.0)))) + 1
    L = np.arange(0, max_layers + 1, dtype=np.float64)
    log_read = (np.log(s) + L * np.log(S_STEP)) / (L + 1.0)
    costs = (L + 1.0) * np.asarray(profile(np.exp(log_read)), dtype=np.float64)
    return int(np.argmin(costs))


def tau_hat(D: KeyPositions, profile: StorageProfile) -> float:
    """τ̂(D; T) for a key-position collection (uses only its extent s_D)."""
    return step_index_complexity(D.size_bytes, profile)
