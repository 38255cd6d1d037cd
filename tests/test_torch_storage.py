"""The port's storage profiles, cost model and index complexity against the
JAX package's.  Inputs: the same constructor arguments, numpy-seeded
widths and the repo's ``gmm``/``books`` key generators (numpy seeds) with
16-byte records.  Tolerance: none — every curve, coefficient, dict and
latency is bit-identical, and each package reads the other's profile
dicts."""
import json
import os
import warnings

import numpy as np
import pytest

import repro.core as R
from repro.core import storage as ref_storage

import repro_torch.core as P
from repro_torch.core import storage as port_storage

from conftest import make_keys

DELTAS = np.concatenate([[0.0, 1.0, 16.0, 255.5], np.geomspace(256, 1 << 26, 23),
                         [3.0e8]])


def _stall(m):
    return m.DistributionalProfile(
        deltas=(4096.0, 65536.0, 1 << 20), means=(1e-4, 3e-4, 2e-3),
        excess=(5e-5, 1e-4, 4e-3), qs=(0.5, 0.99),
        qvalues=((9e-5, 1.2e-4), (2e-4, 2e-3), (1e-3, 3e-2)),
        name="stall-tier")


#: name -> constructor over a package's core module (the same arguments)
PROFILE_MAKERS = {
    "affine": lambda m: m.PROFILES["azure_ssd"],
    "affine-uniform": lambda m: m.AffineUniformProfile(1e-4, 3e-4, 1e8, 4e8),
    "affine-uniform-flat": lambda m: m.AffineUniformProfile(1e-4, 3e-4, 2e8,
                                                            2e8),
    "measured": lambda m: m.MeasuredProfile(
        deltas=(256.0, 4096.0, 65536.0, 1 << 20),
        seconds=(1e-4, 2e-4, 9e-4, 4e-3)),
    "measured-nonmonotone": lambda m: m.MeasuredProfile(
        deltas=(256.0, 4096.0, 65536.0), seconds=(3e-4, 2e-4, 9e-4)),
    "distributional": _stall,
    "objective-affine": lambda m: m.objective_profile(
        m.PROFILES["azure_nfs"], {"p": 0.99, "weight": 1.0}),
    "objective-distributional": lambda m: m.objective_profile(
        _stall(m), {"p": 0.99, "weight": 0.5}),
    "cached-default": lambda m: m.CachedProfile(
        backing=m.PROFILES["azure_nfs"], hit_rate=0.7),
    "cached-explicit": lambda m: m.CachedProfile(
        backing=m.PROFILES["azure_hdd"], cache=m.PROFILES["ssd_ex"],
        hit_rate=0.25),
    "cached-measured": lambda m: m.CachedProfile(
        backing=PROFILE_MAKERS["measured"](m), hit_rate=1.5),
    "cached-distributional": lambda m: m.CachedProfile(
        backing=_stall(m), hit_rate=0.4),
}


@pytest.mark.parametrize("name", sorted(PROFILE_MAKERS))
def test_profile_curves_identical(name):
    port, ref = PROFILE_MAKERS[name](P), PROFILE_MAKERS[name](R)
    assert type(port).__name__ == type(ref).__name__
    np.testing.assert_array_equal(port(DELTAS), ref(DELTAS))
    np.testing.assert_array_equal(port.mean_excess(DELTAS),
                                  ref.mean_excess(DELTAS))
    # 2-D input, as the batched scorer applies it
    W = DELTAS[None, :].repeat(3, axis=0)
    np.testing.assert_array_equal(port(W), ref(W))
    assert P.affine_coefficients(port) == R.affine_coefficients(ref)


@pytest.mark.parametrize("name", sorted(PROFILE_MAKERS))
def test_profile_dicts_identical_and_cross_readable(name):
    port, ref = PROFILE_MAKERS[name](P), PROFILE_MAKERS[name](R)
    d = P.profile_to_dict(port)
    assert d == R.profile_to_dict(ref)
    json.dumps(d)                                   # strict-JSON safe
    back = P.profile_from_dict(json.loads(json.dumps(R.profile_to_dict(ref))))
    assert back == port
    assert R.profile_from_dict(json.loads(json.dumps(d))) == ref
    np.testing.assert_array_equal(back(DELTAS), ref(DELTAS))


def test_profile_dict_edge_cases_identical():
    for d in (None, {}, {"kind": "nope"}, {"kind": "affine"},
              {"kind": "cached", "backing": {"kind": "nope"}},
              {"kind": "objective", "base": None, "p": 0.9, "weight": 1}):
        assert P.profile_from_dict(d) is None and R.profile_from_dict(d) is None
    assert P.profile_to_dict(None) is None and R.profile_to_dict(None) is None


def test_named_profiles_are_the_papers_tiers():
    # every tier of the JAX package is carried verbatim, its TPU-system
    # constants ("object_store", "hbm", "vmem", "ici", "dcn") included; the
    # card's measured memory is the port's own "h100_hbm"
    assert set(P.PROFILES) == set(R.PROFILES) | {"h100_hbm"}
    for name, prof in R.PROFILES.items():
        assert P.profile_to_dict(P.PROFILES[name]) == R.profile_to_dict(prof)
    h100, v5e = P.PROFILES["h100_hbm"], R.PROFILES["hbm"]
    assert P.PROFILES["h100_hbm"].name == "h100_hbm"
    assert (h100.latency, h100.bandwidth) != (v5e.latency, v5e.bandwidth)


@pytest.mark.parametrize("objective", [
    None, "mean", {"p": 0.99}, {"p": 0.9, "weight": 0.5},
    {"p": 0.5, "weight": 0.0}, {"p": 1.0}, {"p": 0.0}, {"weight": 1.0},
    {"p": 0.9, "weight": -1.0}, {"p": 0.9, "bogus": 1}, {"p": "x"}, "p99",
    3])
def test_normalize_objective_identical(objective):
    try:
        want = R.normalize_objective(objective)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.normalize_objective(objective)
        assert str(got.value) == str(e)
        return
    assert P.normalize_objective(objective) == want
    port = P.objective_profile(P.PROFILES["azure_ssd"], objective)
    ref = R.objective_profile(R.PROFILES["azure_ssd"], objective)
    assert P.profile_to_dict(port) == R.profile_to_dict(ref)


@pytest.mark.parametrize("deltas,seconds", [
    ((256.0, 4096.0, 65536.0), (1e-4, 2e-4, 9e-4)),
    ((4096.0, 4096.0), (1e-4, 2e-4)),               # one distinct size
    ((256.0, 4096.0), (3e-4, 3e-4)),                # constant seconds
    ((256.0, 4096.0, 65536.0), (9e-4, 2e-4, 1e-4)),  # negative slope
])
def test_fit_affine_identical(deltas, seconds):
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        port = P.MeasuredProfile(deltas, seconds).fit_affine()
    with warnings.catch_warnings(record=True) as wr:
        warnings.simplefilter("always")
        ref = R.MeasuredProfile(deltas, seconds).fit_affine()
    assert P.profile_to_dict(port) == R.profile_to_dict(ref)
    assert [str(w.message) for w in wp] == [str(w.message) for w in wr]


def test_distributional_fit_identical():
    rng = np.random.default_rng(5)
    samples = [(float(d), float(rng.exponential(1e-4) + d * 1e-9))
               for d in rng.choice([4096, 65536, 1 << 20], 500)]
    port = P.DistributionalProfile.fit(samples, min_samples=32)
    ref = R.DistributionalProfile.fit(samples, min_samples=32)
    assert P.profile_to_dict(port) == R.profile_to_dict(ref)
    np.testing.assert_array_equal(port.quantile_time(DELTAS, 0.97),
                                  ref.quantile_time(DELTAS, 0.97))
    assert P.DistributionalProfile.fit(samples[:10]) is None
    assert R.DistributionalProfile.fit(samples[:10]) is None


def test_profile_local_storage_measures_the_filesystem(tmp_path):
    sizes = [256, 4096, 65536]
    prof = P.profile_local_storage(str(tmp_path / "probe.bin"), sizes=sizes,
                                   repeats=2, file_bytes=1 << 20)
    assert isinstance(prof, P.MeasuredProfile) and prof.name == "local-fs"
    assert prof.deltas == tuple(sizes) and len(prof.seconds) == 3
    assert all(s > 0 for s in prof.seconds)
    assert os.path.getsize(tmp_path / "probe.bin") == 1 << 20
    assert port_storage.profile_local_storage.__doc__ \
        == ref_storage.profile_local_storage.__doc__


# ---------------------------------------------------------------------------
# the cost model: Eq. (5)/(6), batched scoring, tail objective, τ̂
# ---------------------------------------------------------------------------
def _designs(kind):
    """The same three-layer design built by each package's builders."""
    keys = make_keys(kind, 20_000, seed=4)
    out = {}
    for m in (P, R):
        D = m.KeyPositions.fixed_record(keys, 16)
        l1 = m.build_gband(D, 2.0**11)
        o1 = m.outline(l1, D)
        l2 = m.build_gstep(o1, 8, 2.0**10)
        o2 = m.outline(l2, o1)
        l3 = m.build_eband(o2, 2.0**9)
        out[m] = (m.IndexDesign(layers=(l1, l2, l3), data=D),
                  m.IndexDesign(layers=(), data=D))
    return out


@pytest.mark.parametrize("kind", ["gmm", "books"])
@pytest.mark.parametrize("name", ["affine", "measured", "objective-affine",
                                  "distributional", "cached-explicit"])
def test_latency_functions_identical(kind, name):
    designs = _designs(kind)
    for full, empty in (designs[P], designs[R]):
        assert full.n_layers == 3 and empty.n_layers == 0
    port_prof, ref_prof = PROFILE_MAKERS[name](P), PROFILE_MAKERS[name](R)
    for (pd, rd) in zip(designs[P], designs[R]):
        assert P.expected_latency(pd, port_prof) \
            == R.expected_latency(rd, ref_prof)
        assert P.latency_breakdown(pd, port_prof) \
            == R.latency_breakdown(rd, ref_prof)
        assert P.mean_read_volume(pd) == R.mean_read_volume(rd)
        assert P.mean_excess_per_lookup(pd, port_prof) \
            == R.mean_excess_per_lookup(rd, ref_prof)
        assert P.quantile_latency(pd, port_prof, 0.99) \
            == R.quantile_latency(rd, ref_prof, 0.99)
        for obj in ("mean", {"p": 0.99, "weight": 0.5}):
            assert P.objective_latency(pd, port_prof, obj) \
                == R.objective_latency(rd, ref_prof, obj)
        assert pd.describe() == rd.describe()
    assert P.ideal_latency_with_index(port_prof) \
        == R.ideal_latency_with_index(ref_prof)
    with pytest.raises(ValueError):
        P.quantile_latency(designs[P][0], port_prof, 1.0)


@pytest.mark.parametrize("name", sorted(PROFILE_MAKERS))
def test_batched_mean_read_costs_identical(name):
    rng = np.random.default_rng(0)
    W = rng.uniform(1.0, 1e6, size=(7, 1023))
    wt = rng.uniform(0.5, 4.0, size=1023)
    port, ref = PROFILE_MAKERS[name](P), PROFILE_MAKERS[name](R)
    np.testing.assert_array_equal(P.batched_mean_read_costs(W, wt, port),
                                  R.batched_mean_read_costs(W, wt, ref))
    np.testing.assert_array_equal(P.batched_mean_read_costs(W[0], wt, port),
                                  R.batched_mean_read_costs(W[0], wt, ref))


@pytest.mark.parametrize("name", ["affine", "measured", "objective-affine",
                                  "cached-default"])
def test_index_complexity_identical(name):
    port, ref = PROFILE_MAKERS[name](P), PROFILE_MAKERS[name](R)
    assert P.S_STEP == R.S_STEP
    for size in (0, 1, 15, 16, 4096, 1 << 20, 3.2e8, 5e12):
        assert P.step_index_complexity(size, port) \
            == R.step_index_complexity(size, ref)
        assert P.step_index_complexity(size, port, max_layers=2) \
            == R.step_index_complexity(size, ref, max_layers=2)
        assert P.step_index_complexity_layers(size, port) \
            == R.step_index_complexity_layers(size, ref)
    designs = _designs("gmm")
    assert P.tau_hat(designs[P][0].data, port) \
        == R.tau_hat(designs[R][0].data, ref)
