"""AirIndex core for the PyTorch port: key-position collections, layers,
builders and their registries, storage profiles, the Eq. (6) cost, the
AirTune search strategies with the fused sweep engine, the baselines, the
batched float64 Alg. 1 (``lookup_batch``) and the on-disk index format.  Host-side numpy, bit-identical to the JAX
package's ``repro.core`` on what it covers; the sweep engine ranks
candidates on the card by default (``score_backend="cuda"``)."""
from .airtune import (SearchStrategy, TuneResult, TuneStats, airtune,
                      beam_search, brute_force)
from .builders import (DEFAULT_FAMILIES, LayerBuilder, build_eband,
                       build_eband_multi, build_gband, build_gband_multi,
                       build_gstep, build_gstep_multi, build_partitioned,
                       check_disjoint, fit_bands_for_groups,
                       greedy_partition, gstep_from_starts, make_builders,
                       merge_layers)
from .complexity import (S_STEP, step_index_complexity,
                         step_index_complexity_layers, tau_hat)
from .convert import design_from_arrays
from .descent import (coalesce_ranges, covering_index, descend_band_layer,
                      descend_layers, descend_step_layer)
from .keyset import KeyPositions
from .latency import (IndexDesign, batched_mean_read_costs, expected_latency,
                      ideal_latency_with_index, latency_breakdown,
                      mean_excess_per_lookup, mean_read_volume,
                      objective_latency, quantile_latency)
from .nodes import (BAND_NODE_BYTES, STEP_PIECE_BYTES, BandLayer, StepLayer,
                    mean_width, outline)
from .registry import (BUILDER_FAMILIES, MULTI_LAM_FAMILIES,
                       SEARCH_STRATEGIES, Registry, register_builder,
                       register_multi_lam_builder, register_strategy)
from .lookup import (LookupResult, last_mile_search, lookup_batch,
                     verify_lookup)
from .serialize import (IndexFileMeta, LayerMeta, SerializedIndex,
                        lookup_serialized, materialize_design, page_span,
                        parse_meta, read_meta_path, record_aligned_range,
                        write_index)
from .storage import (PROFILES, AffineProfile, AffineUniformProfile,
                      CachedProfile, DistributionalProfile, MeasuredProfile,
                      ObjectiveProfile, StorageProfile, affine_coefficients,
                      normalize_objective, objective_profile,
                      profile_from_dict, profile_local_storage,
                      profile_to_dict)
from .sweep import (DEFAULT_CACHE_ENTRIES, SCORE_BACKENDS, SCORE_SAMPLE,
                    Candidate, LayerCache, SweepEngine, seed_layer_cache)
from . import baselines  # noqa: F401  (registers btree / rmi_leaf / pgm)
from .baselines import (BASELINE_FAMILIES, PGM_EPS_GRID, build_fixed_btree,
                        build_pgm, build_rmi, build_rmi_leaf, data_calculator,
                        homogeneous_airtune, pgm_builders, tune_pgm, tune_rmi)

__all__ = [k for k in dir() if not k.startswith("_")]
