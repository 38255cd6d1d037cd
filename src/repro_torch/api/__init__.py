"""``repro_torch.api`` — the public entry point of the PyTorch port.

One object carries the whole lifecycle::

    from repro_torch.api import Index, TuneSpec

    idx = Index.tune(D, "azure_ssd", TuneSpec(k=5, page_bytes=4096)).build()
    idx.save("index.air")                  # records the spec on disk
    svc = Index.open("index.air", data=D).serve(profile="azure_hdd",
                                                persist_stats=True)

and the observe → drift → warm retune → swap loop runs on it
(:func:`detect_drift`, :meth:`Index.retune`,
:meth:`repro_torch.serve.IndexService.swap`).  The sharded fleet is not
ported yet.
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

__all__ = [
    "Index", "TuneSpec", "ServeSpec", "RetryPolicy", "SERVE_BACKENDS",
    "SearchStrategy", "TuneResult", "TuneStats",
    "DriftReport", "detect_drift", "detect_drift_from_file",
    "drift_from_stats",
    "BASELINE_FAMILIES", "BUILDER_FAMILIES", "SEARCH_STRATEGIES", "Registry",
    "register_builder", "register_strategy",
    "PROFILES", "StorageProfile", "resolve_profile",
]
