"""The port's tuner against the JAX package's: registries, builders on the
Eq. (8) grid, the sweep engine and the three search strategies, the
baselines and ``TuneSpec``.  Inputs: the repo's ``gmm``/``books`` key
generators (numpy seeds), 5,000–8,000 keys with 16-byte records, and the
matrices of the JAX package's ``tests/test_sweep.py`` and
``tests/test_objective.py``.  Tolerance: with ``score_backend="numpy"``
none — layer arrays, costs, ``builder_names`` and every ``TuneStats``
counter are identical (wall seconds aside).  ``score_backend="cuda"`` on
the CPU ranks with the float32 plain version, so its cost is held to the
reference's numpy-ranked cost at rel 1e-6, the reference's own bound for
its device rankers."""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.api import TuneSpec as RefTuneSpec
from repro.core import baselines as ref_baselines
from repro.core.sweep import LayerCache as RefLayerCache

import repro_torch.core as P
from repro_torch.api import TuneSpec
from repro_torch.core import baselines as port_baselines
from repro_torch.core import sweep as port_sweep
from repro_torch.core.sweep import LayerCache

from conftest import make_keys

GRID = dict(lam_low=2**10, lam_high=2**16, base=4.0)
DEFAULT = ("gstep", "gband", "eband")
BASELINE_MIX = ("btree", "pgm", "gstep")
STRATEGIES = {
    "airtune": ("airtune", dict(k=3, max_layers=4)),
    "beam": ("beam_search", dict(k=3, max_layers=4)),
    "brute_force": ("brute_force", dict(max_layers=3)),
}
P99 = {"p": 0.99, "weight": 0.5}


def _stall(m):
    return m.DistributionalProfile(
        deltas=(4096.0, 65536.0, 1 << 20), means=(1e-4, 3e-4, 2e-3),
        excess=(5e-5, 1e-4, 4e-3), qs=(0.5, 0.99),
        qvalues=((9e-5, 1.2e-4), (2e-4, 2e-3), (1e-3, 3e-2)),
        name="stall-tier")


TIERS = {
    "azure_ssd": lambda m: m.PROFILES["azure_ssd"],
    "azure_nfs": lambda m: m.PROFILES["azure_nfs"],
    "measured": lambda m: m.MeasuredProfile(
        deltas=(256.0, 4096.0, 65536.0, 1 << 20),
        seconds=(1e-4, 2e-4, 9e-4, 4e-3)),
    "cached": lambda m: m.CachedProfile(backing=m.PROFILES["azure_nfs"],
                                        hit_rate=0.7),
}

_KEYS = {}


def _keys(kind="gmm", n=5_000, seed=3):
    if (kind, n, seed) not in _KEYS:
        _KEYS[kind, n, seed] = make_keys(kind, n, seed)
    return _KEYS[kind, n, seed]


def _pair(kind="gmm", n=5_000, seed=3):
    keys = _keys(kind, n, seed)
    return (P.KeyPositions.fixed_record(keys, 16),
            R.KeyPositions.fixed_record(keys, 16))


def _layers_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    for la, lb in zip(a, b):
        if la.kind != lb.kind:
            return False
        if la.kind == "step":
            fields = ("piece_keys", "piece_pos", "node_piece_off")
        else:
            fields = ("node_keys", "x1", "y1", "m", "delta")
            if la.clamp_lo != lb.clamp_lo or la.clamp_hi != lb.clamp_hi:
                return False
        if not all(np.array_equal(getattr(la, f), getattr(lb, f))
                   for f in fields):
            return False
    return True


def _counters(stats) -> dict:
    """The reference's TuneStats counters (its fields, seconds aside)."""
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(R.TuneStats)
            if not f.name.endswith("seconds")}


def _assert_same(port, ref):
    assert port.cost == ref.cost                     # bitwise, not approx
    assert port.builder_names == ref.builder_names
    assert _layers_equal(port.design.layers, ref.design.layers)
    assert _counters(port.stats) == _counters(ref.stats)
    assert port.strategy == ref.strategy
    assert port.objective == ref.objective


def _run(sname, D, prof, builders, module, **kw):
    fn_name, base = STRATEGIES[sname]
    return getattr(module, fn_name)(D, prof, builders, **base, **kw)


# ---------------------------------------------------------------------------
# registries and the Eq. (8) grid
# ---------------------------------------------------------------------------
def test_registries_hold_the_same_names():
    assert P.BUILDER_FAMILIES.names() == R.BUILDER_FAMILIES.names()
    assert P.SEARCH_STRATEGIES.names() == R.SEARCH_STRATEGIES.names()
    assert P.MULTI_LAM_FAMILIES.names() == R.MULTI_LAM_FAMILIES.names()
    assert P.DEFAULT_FAMILIES == R.DEFAULT_FAMILIES
    assert port_baselines.BASELINE_FAMILIES == ref_baselines.BASELINE_FAMILIES
    with pytest.raises(KeyError, match="unknown builder family 'nope'"):
        P.make_builders(kinds=("nope",))
    with pytest.raises(ValueError):
        P.make_builders(base=1.0)
    with pytest.raises(ValueError, match="already registered"):
        P.register_builder("gstep", lambda D, lam, p: None)


@pytest.mark.parametrize("kw", [
    {}, GRID, dict(GRID, kinds=BASELINE_MIX),
    dict(lam_low=300, lam_high=5e5, base=3.0, p=8,
         kinds=("rmi_leaf", "eband"))])
def test_make_builders_names_identical(kw):
    port, ref = P.make_builders(**kw), R.make_builders(**kw)
    assert [b.name for b in port] == [b.name for b in ref]
    assert [(b.kind, b.lam, b.p) for b in port] \
        == [(b.kind, b.lam, b.p) for b in ref]


LAMS = [2.0**s for s in range(8, 21, 2)]


@pytest.mark.parametrize("kind", ["gmm", "fb"])
@pytest.mark.parametrize("family", ["gstep", "gband", "eband", "btree", "pgm"])
def test_multi_lam_builders_identical(kind, family):
    Dp, Dr = _pair(kind, n=4_000)
    port = P.MULTI_LAM_FAMILIES.get(family)(Dp, LAMS, 16)
    ref = R.MULTI_LAM_FAMILIES.get(family)(Dr, LAMS, 16)
    assert _layers_equal(port, ref)
    # identical partitions share one layer object in both packages
    assert [len({id(x) for x in port[:i + 1]}) for i in range(len(port))] \
        == [len({id(x) for x in ref[:i + 1]}) for i in range(len(ref))]


@pytest.mark.parametrize("family", ["gstep", "gband", "eband", "btree",
                                    "rmi_leaf", "pgm"])
def test_single_lam_families_identical(family):
    Dp, Dr = _pair("books", n=4_000)
    for lam in (300.0, 2.0**12, 2.0**17):
        port = P.LayerBuilder(family, lam, 8)(Dp)
        ref = R.LayerBuilder(family, lam, 8)(Dr)
        assert _layers_equal([port], [ref])
        assert P.LayerBuilder(family, lam, 8).name \
            == R.LayerBuilder(family, lam, 8).name


def test_partitioned_build_identical():
    Dp, Dr = _pair("gmm", n=6_000)
    for kind in ("gstep", "gband"):
        port = P.build_partitioned(P.LayerBuilder(kind, 2.0**11), Dp, 2_500)
        ref = R.build_partitioned(R.LayerBuilder(kind, 2.0**11), Dr, 2_500)
        assert _layers_equal([port], [ref])


# ---------------------------------------------------------------------------
# the strategies, numpy ranking: bit-identical to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("families", [DEFAULT, BASELINE_MIX],
                         ids=["default", "baselines"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("sname", list(STRATEGIES))
def test_strategy_identical(sname, tier, families):
    Dp, Dr = _pair()
    port = _run(sname, Dp, TIERS[tier](P), P.make_builders(**GRID,
                                                            kinds=families),
                P, score_backend="numpy")
    ref = _run(sname, Dr, TIERS[tier](R), R.make_builders(**GRID,
                                                           kinds=families), R)
    _assert_same(port, ref)
    assert port.stats.est_batches == 0


@pytest.mark.parametrize("tier", ["azure_ssd", "stall"])
@pytest.mark.parametrize("sname", list(STRATEGIES))
def test_p99_objective_identical(sname, tier):
    Dp, Dr = _pair(n=8_000)
    make = _stall if tier == "stall" else TIERS[tier]
    port = _run(sname, Dp, make(P), P.make_builders(**GRID), P,
                score_backend="numpy", objective=P99)
    ref = _run(sname, Dr, make(R), R.make_builders(**GRID), R,
               objective=P99)
    _assert_same(port, ref)
    assert port.objective == {"p": 0.99, "weight": 0.5}


@pytest.mark.parametrize("sname", list(STRATEGIES))
def test_legacy_loop_identical(sname):
    Dp, Dr = _pair("books")
    # the legacy loop ranks in numpy on either backend, but it still
    # takes the caller's backend and device: name the host one
    port = _run(sname, Dp, P.PROFILES["azure_ssd"], P.make_builders(**GRID),
                P, sweep=False, score_backend="numpy")
    ref = _run(sname, Dr, R.PROFILES["azure_ssd"], R.make_builders(**GRID),
               R, sweep=False)
    _assert_same(port, ref)
    with pytest.raises(ValueError, match="sweep engine"):
        _run(sname, Dp, P.PROFILES["azure_ssd"], P.make_builders(**GRID), P,
             sweep=False, score_backend="numpy",
             seed_layers=[("GStep(16,1024)", port.design.layers)])


@pytest.mark.parametrize("sname", ["airtune", "beam"])
def test_warm_start_identical(sname):
    """The azure_ssd design seeds a tune for the same tier behind a 30%-hit
    cache: pure memoization for airtune, initial beam vertices for beam —
    identical in both."""
    Dp, Dr = _pair()
    res = {}
    for m, D, rank in ((P, Dp, dict(score_backend="numpy")), (R, Dr, {})):
        bs = m.make_builders(**GRID)
        prev = _run(sname, D, m.PROFILES["azure_ssd"], bs, m, **rank)
        seed = list(zip(prev.builder_names, prev.design.layers))
        assert seed
        res[m] = _run(sname, D, m.CachedProfile(
            backing=m.PROFILES["azure_ssd"], hit_rate=0.3), bs, m,
            seed_layers=seed, **rank)
    _assert_same(res[P], res[R])
    assert res[P].stats.layers_seeded > 0


def test_shared_layer_cache_identical():
    """One cache across tiers and strategies (brute force first, as the
    reference's certification order): every result and every counter of
    every run equals the reference's, and the cache holds the same
    number of entries."""
    Dp, Dr = _pair(n=8_000)
    caches = {P: LayerCache(), R: RefLayerCache()}
    runs = {P: [], R: []}
    for m, D in ((P, Dp), (R, Dr)):
        bs = m.make_builders(**GRID)
        rank = dict(score_backend="numpy") if m is P else {}
        for tier in ("azure_ssd", "azure_nfs"):
            for sname in ("brute_force", "airtune", "beam"):
                runs[m].append(_run(sname, D, TIERS[tier](m), bs, m,
                                    layer_cache=caches[m], **rank))
        runs[m].append(_run("airtune", D, TIERS["azure_ssd"](m), bs, m,
                            layer_cache=caches[m], objective=P99, **rank))
    for port, ref in zip(runs[P], runs[R]):
        _assert_same(port, ref)
    assert len(caches[P]) == len(caches[R]) > 0
    assert sum(r.stats.layers_reused for r in runs[P]) > 0


def test_bounded_cache_and_unhashable_profile_identical():
    Dp, Dr = _pair(n=4_000)
    out = {}
    for m, D, cache_cls in ((P, Dp, LayerCache), (R, Dr, RefLayerCache)):
        cache = cache_cls(max_entries=5)
        rank = dict(score_backend="numpy") if m is P else {}
        prof = m.MeasuredProfile(deltas=[256.0, 4096.0, 1 << 20],
                                 seconds=[1e-4, 2e-4, 4e-3])
        r1 = m.airtune(D, prof, m.make_builders(**GRID), k=3,
                       layer_cache=cache, **rank)
        r2 = m.airtune(D, prof, m.make_builders(**GRID), k=3,
                       layer_cache=cache, **rank)
        assert prof in cache._pinned_profiles and len(cache) <= 5
        out[m] = (r1, r2, len(cache))
    _assert_same(out[P][0], out[R][0])
    _assert_same(out[P][1], out[R][1])
    assert out[P][2] == out[R][2]


def test_third_party_family_identical():
    def build_wide_step(mod):
        return lambda D, lam, p: mod.build_gstep(D, max(int(p) * 2, 1), lam)

    P.register_builder("widestep_t", build_wide_step(P))
    R.register_builder("widestep_t", build_wide_step(R))
    try:
        Dp, Dr = _pair(n=4_000)
        kinds = ("gstep", "widestep_t")
        port = P.airtune(Dp, P.PROFILES["azure_ssd"],
                         P.make_builders(**GRID, kinds=kinds), k=3,
                         score_backend="numpy")
        ref = R.airtune(Dr, R.PROFILES["azure_ssd"],
                        R.make_builders(**GRID, kinds=kinds), k=3)
        _assert_same(port, ref)
    finally:
        P.BUILDER_FAMILIES.unregister("widestep_t")
        R.BUILDER_FAMILIES.unregister("widestep_t")


# ---------------------------------------------------------------------------
# the device ranking on the CPU: the float32 plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["azure_ssd", "azure_nfs", "cached",
                                  "measured"])
@pytest.mark.parametrize("sname", ["airtune", "beam", "brute_force"])
def test_cuda_ranking_on_cpu_matches_reference_cost(sname, tier):
    Dp, Dr = _pair(n=150_000) if sname == "airtune" else _pair()
    port = _run(sname, Dp, TIERS[tier](P), P.make_builders(**GRID), P,
                device="cpu")
    ref = _run(sname, Dr, TIERS[tier](R), R.make_builders(**GRID), R)
    assert port.cost == pytest.approx(ref.cost, rel=1e-6)
    assert port.cost == pytest.approx(
        P.expected_latency(port.design, TIERS[tier](P)), rel=1e-9)
    # only the ranking strategies rank, and only an affine tier reaches
    # the device scorer
    ranks = sname != "brute_force" and tier != "measured" \
        and port.stats.sweeps > 0
    assert port.stats.sweeps == ref.stats.sweeps
    assert (port.stats.est_batches > 0) == ranks


def test_cuda_estimates_never_share_the_exact_slot():
    Dp, _ = _pair(n=4_000)
    prof = P.PROFILES["azure_ssd"]
    cache = LayerCache()
    stats = P.TuneStats()
    eng = port_sweep.SweepEngine(P.make_builders(**GRID), prof, stats,
                                 layer_cache=cache, device="cpu")
    cands = eng.children(Dp)
    for c in cands:
        assert (prof, "est", "cuda") in c.entry.scores
        assert (prof, "exact") not in c.entry.scores
    assert stats.est_batches == 1
    assert stats.est_copy_seconds > 0 and stats.est_kernel_seconds > 0
    exact = eng.exact_read_costs(Dp, cands)
    np.testing.assert_allclose([c.est_cost for c in cands], exact, rtol=3e-5)
    # numpy ranking of the same small vertex shares the exact slot
    numpy_eng = port_sweep.SweepEngine(P.make_builders(**GRID), prof,
                                       P.TuneStats(), layer_cache=cache,
                                       score_backend="numpy")
    assert [c.est_cost for c in numpy_eng.children(Dp)] == exact


def test_engine_backend_names():
    stats = P.TuneStats()
    bs = P.make_builders(**GRID)
    prof = P.PROFILES["azure_ssd"]
    for name in ("pallas", "jnp", "cuda"):
        eng = port_sweep.SweepEngine(bs, prof, stats, score_backend=name,
                                     device="cpu")
        assert eng.score_backend == "cuda" and eng.device.type == "cpu"
    assert port_sweep.SweepEngine(bs, prof, stats, score_backend="numpy") \
        .device is None
    assert port_sweep.SCORE_BACKENDS == ("cuda", "numpy")
    with pytest.raises(ValueError, match="score_backend"):
        port_sweep.SweepEngine(bs, prof, stats, score_backend="tpu")
    assert port_sweep.SCORE_SAMPLE == R.SCORE_SAMPLE
    assert port_sweep.DEFAULT_CACHE_ENTRIES \
        == R.sweep.DEFAULT_CACHE_ENTRIES


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["azure_ssd", "azure_nfs"])
def test_baseline_tuners_identical(tier):
    Dp, Dr = _pair(n=8_000)
    pp, rp = TIERS[tier](P), TIERS[tier](R)
    for fn in ("tune_rmi", "tune_pgm", "data_calculator"):
        port = getattr(port_baselines, fn)(Dp, pp)
        ref = getattr(ref_baselines, fn)(Dr, rp)
        assert port.cost == ref.cost and port.strategy == ref.strategy
        assert _layers_equal(port.design.layers, ref.design.layers)
        assert _counters(port.stats) == _counters(ref.stats)
    for kind in ("step", "band"):
        port = P.homogeneous_airtune(Dp, pp, kind, score_backend="numpy")
        ref = R.homogeneous_airtune(Dr, rp, kind)
        _assert_same(port, ref)


def test_baseline_builders_identical():
    Dp, Dr = _pair(n=8_000)
    pairs = [(P.build_fixed_btree(Dp), R.build_fixed_btree(Dr)),
             (P.build_fixed_btree(Dp, p=64, lam=2.0**12),
              R.build_fixed_btree(Dr, p=64, lam=2.0**12)),
             (P.build_rmi(Dp, 64), R.build_rmi(Dr, 64)),
             (P.build_pgm(Dp, 32), R.build_pgm(Dr, 32))]
    for port, ref in pairs:
        assert _layers_equal(port.layers, ref.layers)
        assert P.expected_latency(port, P.PROFILES["azure_ssd"]) \
            == R.expected_latency(ref, R.PROFILES["azure_ssd"])
    assert [b.name for b in P.pgm_builders()] \
        == [b.name for b in R.pgm_builders()]
    assert P.PGM_EPS_GRID == R.PGM_EPS_GRID
    for lam in (16.0, 2.0**12, 2.0**30):
        assert port_baselines.rmi_models_for_lam(Dp, lam) \
            == ref_baselines.rmi_models_for_lam(Dr, lam)


# ---------------------------------------------------------------------------
# TuneSpec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {}, dict(families=BASELINE_MIX, k=3, strategy="beam", page_bytes=4096,
             cache_bytes=(1 << 20, 1 << 22), objective=P99),
    dict(lam_low=2**10, lam_high=2**16, lam_base=4.0, p=8, max_layers=3,
         strategy="brute_force")])
def test_tune_spec_identical_and_cross_readable(kw):
    port, ref = TuneSpec(**kw).validate(), RefTuneSpec(**kw).validate()
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()
    assert TuneSpec.from_json(ref.to_json()) == port
    assert RefTuneSpec.from_json(port.to_json()) == ref
    assert [b.name for b in port.builders()] \
        == [b.name for b in ref.builders()]
    assert port.replace(k=7).k == 7 and port.replace(k=7) != port


@pytest.mark.parametrize("bad", [
    dict(families=()), dict(families=("nope",)), dict(strategy="nope"),
    dict(lam_base=1.0), dict(lam_low=4.0, lam_high=2.0), dict(k=0),
    dict(page_bytes=-1), dict(cache_bytes=(-1,)),
    dict(objective={"p": 2.0})])
def test_tune_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises((KeyError, ValueError)) as ref_err:
        RefTuneSpec(**bad).validate()
    with pytest.raises(ref_err.type):
        TuneSpec(**bad).validate()
    with pytest.raises(ValueError, match="unknown TuneSpec fields"):
        TuneSpec.from_dict({"bogus": 1})
