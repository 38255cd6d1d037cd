"""Files, specs and public names the JAX package hands the port: its named
storage tiers (``object_store``, ``hbm``, ``vmem``, ``ici``, ``dcn``) open,
serve and tune in the port with the reference's constants; the card's
measured memory is a tier of its own name, ``h100_hbm``; every package
of the reference with an ``__all__`` exists in the port and exports the
reference's public names; and the reference's other public names the
port carries (``read_meta``, ``LAYER_KINDS``, the ssm block specs, the
two-tuple ``fused_descent``) behave as the reference's.

Inputs: the repo's ``gmm`` key generator (numpy seeds), 2,000 and 20,000
keys with 16-byte records, 700 queries drawn with numpy seed 5 (the
repro steps of ROADMAP.md F1 and F2).  Tolerance: none for ranges and
counters (the serving walk is float64 numpy in both packages); tuned
costs within 1e-12 relative (the tuner is bit-identical with numpy
ranking)."""
import dataclasses
import importlib
import os

import numpy as np
import pytest

import repro.api as RA
import repro.core as RC
from repro.core import KeyPositions as RefKP
from repro.serve.index_service import demo_serving_design as ref_demo

import repro_torch.api as PA
import repro_torch.core as PC
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


def _packages_with_all(root: str) -> set:
    """Dotted names (below the top package) of the packages under
    ``root`` whose ``__init__.py`` defines ``__all__``."""
    out = set()
    for here, _, files in os.walk(root):
        if "__init__.py" not in files or here == root:
            continue
        with open(os.path.join(here, "__init__.py"), encoding="utf-8") as fh:
            if "__all__" in fh.read():
                out.add(os.path.relpath(here, root).replace(os.sep, "."))
    return out


SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
#: every package of the reference with an ``__all__``; the port must
#: have each, with an ``__all__`` (the F5 contract)
REF_PACKAGES = sorted(_packages_with_all(os.path.join(SRC, "repro")))

#: names the reference exports that the port leaves out: none (the legacy
#: shims, ``load_index`` among them, are ported)
NOT_PORTED: dict = {}
#: names only the port exports
PORT_ONLY = {"core": {"DEFAULT_CACHE_ENTRIES", "LayerCache", "LayerMeta",
                      "SCORE_BACKENDS", "check_disjoint", "convert",
                      "descend_layers", "design_from_arrays",
                      "lookup_serialized", "parse_meta", "read_meta_path",
                      "seed_layer_cache"},
             "serve": {"demo_serving_design"},
             "api": {"SERVE_BACKENDS"},
             # the kernel module, its plain versions and the device helper
             "kernels.fused_descent": {"FusedDescent", "fused_descent_ref",
                                       "fused_descent_torch",
                                       "resolve_device"},
             "kernels.candidate_score": {"BACKENDS", "affine_scores",
                                         "affine_scores_cuda",
                                         "affine_scores_torch",
                                         "timed_affine_scores"}}


def test_every_reference_package_with_names_is_compared():
    assert set(REF_PACKAGES) >= {"core", "serve", "api", "fleet",
                                 "kernels.fused_descent",
                                 "kernels.candidate_score", "analysis",
                                 "analysis.rules", "dist"}
    assert set(NOT_PORTED) | set(PORT_ONLY) <= set(REF_PACKAGES)


@pytest.mark.parametrize("name", REF_PACKAGES)
def test_public_names_equal_the_references(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    assert set(port.__all__) == \
        (set(ref.__all__) - NOT_PORTED.get(name, set())) \
        | PORT_ONLY.get(name, set())
    for sym in set(ref.__all__) - NOT_PORTED.get(name, set()):
        assert getattr(port, sym) is not None


def test_read_meta_reads_a_raw_fd_as_the_reference(tmp_path):
    path, _ = _served_file(tmp_path, "host_dram")
    fd = os.open(path, os.O_RDONLY)  # airlint: allow[pread-seam] -- test
    try:
        got, want = PC.serialize.read_meta(fd), RC.serialize.read_meta(fd)
    finally:
        os.close(fd)
    assert got.to_json() == want.to_json()
    assert got == PC.serialize.read_meta_path(path)


def test_layer_kinds_and_the_ssm_block_specs_equal_the_references():
    from repro import configs as jconfigs
    from repro.core import nodes as rnodes
    from repro.models import ssm as rssm
    from repro_torch import configs as tconfigs
    from repro_torch.core import nodes as pnodes
    from repro_torch.models import ssm as pssm
    assert pnodes.LAYER_KINDS == rnodes.LAYER_KINDS
    for smoke in (True, False):
        jc = jconfigs.get_config("zamba2-1.2b", smoke=smoke)
        tc = tconfigs.get_config("zamba2-1.2b", smoke=smoke)

        def same(t, j):
            assert t.keys() == j.keys()
            for k in j:
                assert tuple(t[k].shape) == tuple(j[k].shape), k
                assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), k
        for L in (1, 3, jc.n_layers):
            same(pssm.mamba_block_specs(tc, L), rssm.mamba_block_specs(jc, L))
        same(pssm.shared_block_specs(tc), rssm.shared_block_specs(jc))


def _resident_prefix(rng, L=3, P=640):
    """A top-down parsed prefix of ``L`` layers of about ``P`` entries,
    step and band layers in turn, keys below 2^31 (the device guard)."""
    layers = []
    for l in range(L):
        n = int(rng.integers(P - 127, P + 1))
        keys = np.concatenate([[1], np.sort(rng.choice(
            np.arange(2, 2**31 - 2, 9973), n - 1, replace=False))])
        if l % 2:
            y1 = np.sort(rng.integers(0, 2**24, n)).astype(np.float64)
            x_next = np.append(keys[1:], 2**31 - 1).astype(np.float64)
            y_next = np.append(y1[1:], 2.0**24)
            layers.append({"kind": "band", "x1": keys.astype(np.uint64),
                           "y1": y1, "m": (y_next - y1) / (x_next - keys),
                           "delta": rng.uniform(1, 600, n)})
        else:
            pos = np.sort(rng.integers(0, 2**30, n + 1))
            layers.append({"kind": "step", "keys": keys.astype(np.uint64),
                           "pos_lo": pos[:-1], "pos_hi": pos[1:]})
    return layers


def test_fused_descent_two_tuple_entry_equals_the_references():
    from repro.kernels import fused_descent as rfd
    from repro_torch.kernels import fused_descent as pfd
    rng = np.random.default_rng(21)
    layers = _resident_prefix(rng)
    q = rng.integers(1, 2**31 - 2, 700).astype(np.uint64)
    want = rfd.fused_descent(layers, q, backend="numpy")
    got = pfd.fused_descent(layers, q, backend="numpy")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the device path on the CPU (the plain version), packed or not, is
    # the one fused_descent_with_backend serves, and it equals the JAX
    # package's device path (interpret mode): step rows exact, band rows
    # widened by the same f32 slack
    lo, hi, used = pfd.fused_descent_with_backend(layers, q, device="cpu")
    assert used == "cuda"
    jlo, jhi = rfd.fused_descent(layers, q, backend="jnp")
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    for kw in ({}, {"packed": pfd.pack_prefix(layers)}):
        glo, ghi = pfd.fused_descent(layers, q, device="cpu", **kw)
        np.testing.assert_array_equal(glo, lo)
        np.testing.assert_array_equal(ghi, hi)


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
