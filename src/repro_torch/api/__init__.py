"""``repro_torch.api`` — the public entry point of the PyTorch port.

One object carries the whole lifecycle::

    from repro_torch.api import Index, TuneSpec

    idx = Index.tune(D, "azure_ssd", TuneSpec(k=5, page_bytes=4096)).build()
    idx.save("index.air")                  # records the spec on disk
    svc = Index.open("index.air", data=D).serve(profile="azure_hdd",
                                                persist_stats=True)

and the observe → drift → warm retune → swap loop runs on it
(:func:`detect_drift`, :meth:`Index.retune`,
:meth:`repro_torch.serve.IndexService.swap`).  The sharded fleet
(:class:`Fleet`, :class:`FleetService`, :class:`FleetSpec`,
:class:`ShardMap`) serves N key-range shards under one cache budget.
"""
from repro_torch.core.airtune import SearchStrategy, TuneResult, TuneStats
from repro_torch.core.baselines import BASELINE_FAMILIES
from repro_torch.core.registry import (BUILDER_FAMILIES, SEARCH_STRATEGIES,
                                       Registry, register_builder,
                                       register_strategy)
from repro_torch.core.storage import PROFILES, StorageProfile

from .drift import (DriftReport, detect_drift, detect_drift_from_file,
                    drift_from_stats)
from .index import Index, resolve_profile
from .spec import SERVE_BACKENDS, RetryPolicy, ServeSpec, TuneSpec

# the fleet sits above the facade (its modules import api.index and
# api.spec), so its names come after the locals above, from its submodules
from repro_torch.fleet.fleet import Fleet  # noqa: E402
from repro_torch.fleet.service import FleetService  # noqa: E402
from repro_torch.fleet.spec import FleetSpec, ShardMap  # noqa: E402

__all__ = [
    "Index", "TuneSpec", "ServeSpec", "RetryPolicy", "SERVE_BACKENDS",
    "Fleet", "FleetSpec", "FleetService", "ShardMap",
    "SearchStrategy", "TuneResult", "TuneStats",
    "DriftReport", "detect_drift", "detect_drift_from_file",
    "drift_from_stats",
    "BASELINE_FAMILIES", "BUILDER_FAMILIES", "SEARCH_STRATEGIES", "Registry",
    "register_builder", "register_strategy",
    "PROFILES", "StorageProfile", "resolve_profile",
]
