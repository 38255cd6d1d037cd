"""Fused multi-layer descent: the Hopper kernel, its plain versions, the
packing guards and the dispatch."""
from .ops import (MAX_VMEM_ENTRIES, FusedDescent, band_f32_slack,
                  fused_descent, fused_descent_with_backend, pack_prefix,
                  resolve_device)
from .ref import fused_descent_ref, fused_descent_torch

__all__ = ["FusedDescent", "MAX_VMEM_ENTRIES", "band_f32_slack",
           "fused_descent", "fused_descent_ref", "fused_descent_torch",
           "fused_descent_with_backend", "pack_prefix", "resolve_device"]
