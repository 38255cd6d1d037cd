"""Storage performance profiles ``T(Δ)`` (paper §3.2).

``T(Δ)`` is the expected time to read ``Δ`` consecutive bytes from a storage
tier.  The paper implements the affine profile ``T_aff(Δ) = ℓ + Δ/B``; the
serving engine charges every pread it issues against one, so its modeled
seconds follow the deployment tier.

``PROFILES`` holds the paper's tiers and host DRAM (the block cache's hit
cost).  Tiers of a particular accelerator system are not carried: their
constants must be measured on the machine that serves.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class StorageProfile:
    """Monotone non-decreasing expected read time ``T(Δ)`` in seconds."""

    name: str = "abstract"

    def read_time(self, delta):
        """Vectorized ``T(Δ)``; ``delta`` in bytes (scalar or ndarray)."""
        raise NotImplementedError

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


PROFILES = {
    # paper §2.1 worked example
    "ssd_ex":    AffineProfile(100e-6, 1e9,    name="ssd_ex"),     # 100 µs, 1 GB/s
    "cloud_ex":  AffineProfile(100e-3, 100e6,  name="cloud_ex"),   # 100 ms, 100 MB/s
    # paper §7 experimental tiers (Fig. 3 / Fig. 14 constants)
    "azure_ssd": AffineProfile(250e-6, 175e6,  name="azure_ssd"),  # 250 µs, 175 MB/s
    "azure_nfs": AffineProfile(50e-3,  12e6,   name="azure_nfs"),  # 50 ms, 12 MB/s
    "azure_hdd": AffineProfile(2e-3,   60e6,   name="azure_hdd"),  # 500 IOPS, 60 MB/s
    # host DRAM: the block cache's hit cost
    "host_dram": AffineProfile(150e-9, 50e9,   name="host_dram"),
}
