"""Batched per-layer index lookup (the in-memory Alg. 1): the Hopper step,
band and segmented-step kernels, their plain PyTorch versions and the
``traverse_index`` chain."""
from . import kernel, ref
from .kernel import (band_lookup_cuda, segmented_step_lookup_cuda,
                     step_lookup_cuda)
from .ops import (LANE, MAX_VMEM_ENTRIES, device_arrays_from_design,
                  lookup_band_layer, lookup_step_layer, segment_bases,
                  traverse_index, two_level_torch)
from .ref import (band_lookup_torch, segmented_step_lookup_torch,
                  step_lookup_torch)

__all__ = ["LANE", "MAX_VMEM_ENTRIES", "band_lookup_cuda",
           "band_lookup_torch", "device_arrays_from_design", "kernel",
           "lookup_band_layer", "lookup_step_layer", "ref",
           "segment_bases", "segmented_step_lookup_cuda",
           "segmented_step_lookup_torch",
           "step_lookup_cuda", "step_lookup_torch", "traverse_index",
           "two_level_torch"]
