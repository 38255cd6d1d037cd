"""AirIndex core for the PyTorch port: key-position collections, layers,
builders, storage profiles and the on-disk index format.  Host-side numpy,
bit-identical to the JAX package's ``repro.core`` on what it covers."""
from .builders import (build_eband, build_gband, build_gstep,
                       check_disjoint, fit_bands_for_groups,
                       greedy_partition, gstep_from_starts)
from .convert import design_from_arrays
from .descent import (coalesce_ranges, covering_index, descend_band_layer,
                      descend_layers, descend_step_layer)
from .keyset import KeyPositions
from .latency import IndexDesign
from .nodes import BandLayer, StepLayer, mean_width, outline
from .serialize import (IndexFileMeta, LayerMeta, SerializedIndex,
                        lookup_serialized, parse_meta, read_meta_path,
                        write_index)
from .storage import PROFILES, AffineProfile, StorageProfile

__all__ = [
    "AffineProfile", "BandLayer", "IndexDesign", "IndexFileMeta",
    "KeyPositions", "LayerMeta", "PROFILES", "SerializedIndex",
    "StepLayer", "StorageProfile", "build_eband", "build_gband",
    "build_gstep", "check_disjoint", "coalesce_ranges", "covering_index",
    "descend_band_layer", "descend_layers", "descend_step_layer",
    "design_from_arrays", "fit_bands_for_groups", "greedy_partition",
    "gstep_from_starts", "lookup_serialized", "mean_width", "outline",
    "parse_meta", "read_meta_path", "write_index",
]
