"""Files, specs and public names the JAX package hands the port: its named
storage tiers (``object_store``, ``hbm``, ``vmem``, ``ici``, ``dcn``) open,
serve and tune in the port with the reference's constants; the card's
measured memory is a tier of its own name, ``h100_hbm``; and the port's
``core``, ``serve`` and ``api`` export the reference's public names.

Inputs: the repo's ``gmm`` key generator (numpy seeds), 2,000 and 20,000
keys with 16-byte records, 700 queries drawn with numpy seed 5 (the
repro steps of ROADMAP.md F1 and F2).  Tolerance: none for ranges and
counters (the serving walk is float64 numpy in both packages); tuned
costs within 1e-12 relative (the tuner is bit-identical with numpy
ranking)."""
import dataclasses

import numpy as np
import pytest

import repro.api as RA
import repro.core as RC
import repro.fleet as RF
import repro.serve as RS
from repro.core import KeyPositions as RefKP
from repro.serve.index_service import demo_serving_design as ref_demo

import repro_torch.api as PA
import repro_torch.core as PC
import repro_torch.fleet as PF
import repro_torch.serve as PS
from repro_torch.core import KeyPositions
from repro_torch.serve import IndexService

from conftest import make_keys

#: the reference's tiers that name TPU-system constants, carried verbatim
REFERENCE_TIERS = ("object_store", "hbm", "vmem", "ici", "dcn")
#: ServeStats fields that hold measured walls (or samples of them)
WALL_FIELDS = {"descent_seconds", "prefetch_seconds",
               "overlapped_pread_seconds", "pread_seconds", "read_samples",
               "lookup_samples"}


def _served_file(tmp_path, cache_profile: str):
    """ROADMAP.md F1's first repro: the JAX package writes the demo design
    over 20,000 gmm keys with ``ServeSpec(cache_profile=...)``; 700
    queries from numpy seed 5."""
    keys = make_keys("gmm", 20_000, seed=11)
    path = str(tmp_path / f"{cache_profile}.air")
    RA.Index.from_design(
        ref_demo(RefKP.fixed_record(keys, 16)),
        spec=RA.TuneSpec(page_bytes=1024), profile="azure_ssd").save(
            path, serve_spec=RA.ServeSpec(cache_profile=cache_profile))
    return path, np.random.default_rng(5).choice(keys, 700)


def _serve_both(path, q):
    ref_svc = RA.Index.open(path).serve()
    try:
        want, ref_stats = ref_svc.lookup(q), ref_svc.stats
    finally:
        ref_svc.close()
    with IndexService(path, device="cpu") as svc:
        got, stats = svc.lookup(q), svc.stats
    return got, want, stats, ref_stats


def _counters(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in WALL_FIELDS}


@pytest.mark.parametrize("cache_profile", ["object_store", "vmem"])
def test_reference_tier_cache_profile_file_serves_in_the_port(tmp_path,
                                                             cache_profile):
    path, q = _served_file(tmp_path, cache_profile)
    got, want, stats, ref_stats = _serve_both(path, q)
    np.testing.assert_array_equal(got, want)
    assert _counters(stats) == _counters(ref_stats)


def test_tune_for_the_object_store_tier_equals_the_reference():
    keys = make_keys("gmm", 2_000, 3)
    spec = dict(lam_high=2**12, k=2, max_layers=2)
    ref = RA.Index.tune(RefKP.fixed_record(keys, 16), profile="object_store",
                        spec=RA.TuneSpec(**spec)).build().result
    got = PA.Index.tune(KeyPositions.fixed_record(keys, 16),
                        profile="object_store", spec=PA.TuneSpec(**spec),
                        device="cpu", score_backend="numpy").build().result
    assert got.builder_names == ref.builder_names
    assert got.design.describe() == ref.design.describe()
    assert abs(got.cost - ref.cost) <= 1e-12 * abs(ref.cost)


def test_hbm_means_the_reference_tier_in_both_packages(tmp_path):
    """ROADMAP.md F2: on one file served with ``cache_profile="hbm"``,
    the modeled seconds and every counter but the walls agree."""
    path, q = _served_file(tmp_path, "hbm")
    got, want, stats, ref_stats = _serve_both(path, q)
    np.testing.assert_array_equal(got, want)
    assert stats.modeled_seconds == ref_stats.modeled_seconds
    assert _counters(stats) == _counters(ref_stats)
    for name in REFERENCE_TIERS:
        assert PC.profile_to_dict(PC.PROFILES[name]) == \
            RC.profile_to_dict(RC.PROFILES[name])


#: names the reference exports that the port leaves out by decision (the
#: legacy shims of ROADMAP.md queue 1)
NOT_PORTED = {"core": {"load_index"},
              "serve": set(),
              "api": set(),
              "fleet": set()}
#: names only the port exports
PORT_ONLY = {"core": {"DEFAULT_CACHE_ENTRIES", "LayerCache", "LayerMeta",
                      "SCORE_BACKENDS", "check_disjoint", "convert",
                      "descend_layers", "design_from_arrays",
                      "lookup_serialized", "parse_meta", "read_meta_path",
                      "seed_layer_cache"},
             "serve": {"demo_serving_design"},
             "api": {"SERVE_BACKENDS"},
             "fleet": set()}


@pytest.mark.parametrize("name,ref,port", [("core", RC, PC),
                                           ("serve", RS, PS),
                                           ("api", RA, PA),
                                           ("fleet", RF, PF)])
def test_public_names_equal_the_references(name, ref, port):
    assert set(port.__all__) == \
        (set(ref.__all__) - NOT_PORTED[name]) | PORT_ONLY[name]
    for sym in set(ref.__all__) - NOT_PORTED[name]:
        assert getattr(port, sym) is not None


def test_index_service_exposes_its_storage_backend(tmp_path):
    path, q = _served_file(tmp_path, "host_dram")
    ref_svc = RA.Index.open(path).serve()
    svc = IndexService(path, device="cpu")
    try:
        assert isinstance(svc.storage, PS.StorageBackend)
        assert svc.storage.size() == ref_svc.storage.size()
    finally:
        svc.close()
        ref_svc.close()
    assert svc.storage is None and ref_svc.storage is None
