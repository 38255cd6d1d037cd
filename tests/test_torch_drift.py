"""The observe → drift → warm retune → swap loop of the port against the
JAX package's: persisted ``ServeStats``, the observed-profile fits,
``DriftReport``s, and ``IndexService.swap``.

Inputs: the matrix of the JAX package's ``tests/test_drift.py`` (``gmm``
60,000 keys, numpy seed 5, its ``TuneSpec``), query batches from numpy
seeds, ``FaultInjectingBackend`` seeds.  Both packages serve the same
file with the numpy backend where counters are compared (the port's
``"cuda"`` backend on the CPU where only ranges are).  Tolerance: none —
reports from the same snapshot, stats files, ranges and counters are
identical; fields measured on the wall clock (pread and lookup seconds,
and what is fitted from them) are compared only in structure."""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest

import repro.api as RA
from repro.api.drift import drift_from_stats as ref_drift_from_stats
from repro.core import KeyPositions as RefKP
from repro.serve import backend as ref_backend
from repro.serve import index_service as ref_is

import repro_torch.api as PA
from repro_torch.api import drift
from repro_torch.core import PROFILES, KeyPositions
from repro_torch.serve import backend, index_service
from repro_torch.serve.index_service import (ServeStats, demo_serving_design,
                                             load_serve_stats,
                                             load_stats_history,
                                             observed_profile_from_stats,
                                             save_stats_snapshot, stats_path)

from conftest import make_keys

SPEC = dict(lam_low=2**8, lam_high=2**15, lam_base=4.0, k=3, max_layers=6,
            page_bytes=1024, cache_bytes=(64 << 10, 512 << 10))
CPU = dict(device="cpu", score_backend="numpy")
# the report's fields that come from wall-clock lookup samples
WALL_REPORT = ("observed_p50_us", "observed_p99_us")
WALL_STATS = {"pread_seconds", "descent_seconds", "prefetch_seconds",
              "overlapped_pread_seconds", "read_samples", "lookup_samples"}


def _serve_some(svc, keys, n_batches=4, batch=200, seed=0):
    rng = np.random.default_rng(seed)
    return [svc.lookup(rng.choice(keys, batch)) for _ in range(n_batches)]


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    keys = make_keys("gmm", 60_000, seed=5)
    pD = KeyPositions.fixed_record(keys, 16)
    rD = RefKP.fixed_record(keys, 16)
    idx = PA.Index.tune(pD, "azure_ssd", PA.TuneSpec(**SPEC), **CPU).build()
    ridx = RA.Index.tune(rD, "azure_ssd", RA.TuneSpec(**SPEC)).build()
    root = tmp_path_factory.mktemp("torch_drift")
    path, rpath = str(root / "index.air"), str(root / "ref.air")
    idx.save(path)
    ridx.save(rpath)
    with open(path, "rb") as f, open(rpath, "rb") as g:
        assert f.read() == g.read()
    return pD, rD, idx, ridx, path


def _counters(stats) -> dict:
    d = dataclasses.asdict(stats)
    out = {k: v for k, v in d.items() if k not in WALL_STATS}
    out["read_samples"] = [(r[0], r[2], r[3]) for r in stats.read_samples]
    out["lookup_samples"] = [r[0] for r in stats.lookup_samples]
    return out


def _report(rep) -> dict:
    d = rep.to_dict()
    for k in WALL_REPORT:
        assert (d.pop(k) is None) == (rep.observed_p50_seconds is None)
    return d


# ---------------------------------------------------------------------------
# persisted ServeStats
# ---------------------------------------------------------------------------
def test_serve_stats_snapshot_roundtrip_and_observed_profile(tuned):
    pD, _, idx, _, path = tuned
    svc = idx.serve(profile="azure_nfs", persist_stats=True)
    _serve_some(svc, pD.keys)
    live_stats = dataclasses.replace(
        svc.stats, read_samples=list(svc.stats.read_samples))
    live_cached = svc.cached_profile()
    live_observed = svc.observed_profile()
    svc.close()                                    # persist_stats → snapshot
    assert os.path.exists(stats_path(path))
    loaded = load_serve_stats(path)
    assert loaded == live_stats
    assert loaded.query_modeled_seconds == live_stats.query_modeled_seconds
    re_obs = observed_profile_from_stats(loaded, PROFILES["azure_nfs"],
                                         PROFILES["host_dram"])
    assert re_obs == live_observed
    assert observed_profile_from_stats(
        loaded, PROFILES["azure_nfs"], PROFILES["host_dram"],
        measured=False) == live_cached
    # the JAX package loads the port's file to the same stats and fits
    ref_loaded = ref_is.load_serve_stats(path)
    assert ref_loaded.snapshot() == loaded.snapshot()
    import repro.core as R
    ref_obs = ref_is.observed_profile_from_stats(
        ref_loaded, R.PROFILES["azure_nfs"], R.PROFILES["host_dram"])
    assert ref_obs.hit_rate == re_obs.hit_rate
    assert dataclasses.asdict(ref_obs.backing) \
        == dataclasses.asdict(re_obs.backing)
    os.unlink(stats_path(path))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stats_window_rotates_and_either_package_reads_it(tuned, writer):
    path = tuned[4]
    save = save_stats_snapshot if writer == "port" \
        else ref_is.save_stats_snapshot
    stats_cls = ServeStats if writer == "port" else ref_is.ServeStats
    s = stats_cls(queries=1)
    for i in range(7):
        s.queries = i
        save(path, s, profile_name="azure_ssd", window=5)
    for load in (load_stats_history, ref_is.load_stats_history):
        hist = load(path)
        assert [h["stats"]["queries"] for h in hist] == [2, 3, 4, 5, 6]
        assert all(h["profile"] == "azure_ssd" for h in hist)
    assert load_serve_stats(path).snapshot() \
        == ref_is.load_serve_stats(path).snapshot()
    with open(stats_path(path)) as f:
        body = f.read()
    os.unlink(stats_path(path))
    save_stats_snapshot(path, ServeStats(queries=6), profile_name="azure_ssd")
    ref_is.save_stats_snapshot(path + ".ref", ref_is.ServeStats(queries=6),
                               profile_name="azure_ssd")
    with open(stats_path(path)) as f, open(stats_path(path + ".ref")) as g:
        assert f.read() == g.read()               # byte-identical files
    assert json.loads(body)["version"] == 1
    os.unlink(stats_path(path))
    os.unlink(stats_path(path + ".ref"))


def test_damaged_stats_files_degrade_alike(tuned):
    path = tuned[4]
    for body in ("{not json", "[]", '{"snapshots": 3}',
                 '{"snapshots": [1, {"stats": {"queries": "x"}}]}'):
        with open(stats_path(path), "w") as f:
            f.write(body)
        with pytest.warns(RuntimeWarning):
            port = load_serve_stats(path)
        with pytest.warns(RuntimeWarning):
            ref = ref_is.load_serve_stats(path)
        assert port is None and ref is None
        with pytest.warns(RuntimeWarning):
            rep = drift.detect_drift_from_file(path)
        with pytest.warns(RuntimeWarning):
            ref_rep = RA.detect_drift_from_file(path)
        assert rep.action == ref_rep.action == "observe"
        assert rep.to_dict() == ref_rep.to_dict()
    os.unlink(stats_path(path))
    assert drift.detect_drift_from_file(path) is None


def test_cacheable_working_set_identical(tuned):
    from repro_torch.core import read_meta_path
    meta = read_meta_path(tuned[4])
    for r in (0, 1, 2, 5):
        assert index_service.cacheable_working_set(meta, r) \
            == ref_is.cacheable_working_set(meta, r)


# ---------------------------------------------------------------------------
# drift reports
# ---------------------------------------------------------------------------
def _stats_pair(seed):
    """The same reservoir and counters in both packages' ServeStats."""
    out = []
    for mod in (index_service, ref_is):
        st = mod.ServeStats(sample_seed=seed)
        r = np.random.default_rng(seed)
        for _ in range(600):
            st.record_read(int(r.choice([1024, 4096, 16384])),
                           float(r.uniform(1e-4, 3e-3)),
                           overlapped=bool(r.random() < 0.3),
                           tainted=bool(r.random() < 0.1))
        for _ in range(50):
            st.record_lookup(int(r.integers(1, 300)), float(r.random()))
        st.queries, st.pages_hit, st.pages_fetched = 2000, 300, 700
        st.modeled_seconds, st.open_modeled_seconds = 3.0, 0.5
        st.data_modeled_seconds = 0.75
        st.walk_modeled_seconds = float(r.uniform(1.0, 8.0))
        out.append(st)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("measured,distributional", [
    (True, False), (True, True), (False, False)])
def test_same_snapshot_gives_equal_drift_reports(seed, measured,
                                                 distributional):
    import repro.core as R
    port, ref = _stats_pair(seed)
    assert port.snapshot() == ref.snapshot()
    for recorded in (None, 5e-4, 1e-3, 4e-3):
        got = drift.drift_from_stats(
            port, recorded, backing=PROFILES["azure_hdd"],
            cache=PROFILES["host_dram"], measured=measured,
            distributional=distributional, min_queries=1000)
        want = ref_drift_from_stats(
            ref, recorded, backing=R.PROFILES["azure_hdd"],
            cache=R.PROFILES["host_dram"], measured=measured,
            distributional=distributional, min_queries=1000)
        assert got.to_dict() == want.to_dict()
        assert dataclasses.asdict(got.observed_profile) \
            == dataclasses.asdict(want.observed_profile)
    assert (drift.DRIFT_RATIO, drift.MIN_QUERIES) == (1.25, 512) \
        == (RA.drift.DRIFT_RATIO, RA.drift.MIN_QUERIES)


def test_fault_dominated_window_reports_observe():
    s = ServeStats(queries=5000, modeled_seconds=1.0,
                   walk_modeled_seconds=9.0)
    for i in range(20):
        s.record_read(4096, 1e-3, tainted=i > 3)
    rep = drift.drift_from_stats(s, recorded_cost=1e-4, min_queries=10)
    assert rep.confidence == 0.0 and rep.action == "observe"


def test_no_drift_on_the_tuned_tier(tuned):
    pD, rD, idx, ridx, _ = tuned
    with idx.serve(profile="azure_ssd", backend="numpy") as svc:
        got = _serve_some(svc, pD.keys)
        rep = drift.detect_drift(svc, min_queries=256, measured=False)
    rsvc = ridx.serve(profile="azure_ssd", backend="numpy")
    try:
        want = _serve_some(rsvc, rD.keys)
        ref_rep = RA.detect_drift(rsvc, min_queries=256, measured=False)
    finally:
        rsvc.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0.9 < rep.ratio < 1.1 and rep.action == "none"
    assert rep.confidence == 1.0 and not rep.drifted
    assert _report(rep) == _report(ref_rep)


def test_drift_on_a_degraded_tier(tuned):
    pD, _, idx, _, path = tuned
    with idx.serve(profile="azure_hdd", persist_stats=True) as svc:
        _serve_some(svc, pD.keys)
        rep = idx.observe(svc, min_queries=256)
    assert rep.drifted and rep.action == "retune" and rep.ratio > 1.25
    assert rep.observed_profile.hit_rate == rep.hit_rate
    off = drift.detect_drift_from_file(path, backing="azure_hdd",
                                       min_queries=256)
    assert off.ratio == rep.ratio and off.action == rep.action
    dflt = idx.observe_offline(min_queries=256)
    assert dflt.observed_profile == rep.observed_profile
    # the JAX package reads the port's snapshot to the same report
    ref_off = RA.detect_drift_from_file(path, min_queries=256)
    assert ref_off.to_dict() == dflt.to_dict()
    os.unlink(stats_path(path))


def test_no_drift_with_extra_resident_layers(tmp_path):
    keys = make_keys("gmm", 80_000, seed=7)
    D = KeyPositions.fixed_record(keys, 16)
    idx = PA.Index.from_design(demo_serving_design(D),
                               spec=PA.TuneSpec(page_bytes=1024),
                               profile="azure_ssd", **CPU)
    path = str(tmp_path / "res.air")
    idx.save(path)
    with index_service.IndexService(
            path, profile="azure_ssd", device="cpu",
            spec=PA.ServeSpec(resident_layers=3)) as svc:
        _serve_some(svc, D.keys)
        rep = drift.detect_drift(svc, min_queries=256)
    assert 0.9 < rep.ratio < 1.25 and rep.action == "none", rep.describe()


def test_drift_needs_queries_and_provenance(tuned, tmp_path):
    pD, _, idx, _, _ = tuned
    with idx.serve(profile="azure_hdd") as svc:
        svc.lookup(pD.keys[:8])
        rep = drift.detect_drift(svc)
    assert rep.action == "observe" and rep.confidence < 1.0
    keys = make_keys("books", 30_000, seed=2)
    D = KeyPositions.fixed_record(keys, 16)
    from repro_torch.core import write_index
    raw = str(tmp_path / "raw.air")
    write_index(raw, demo_serving_design(D), page_bytes=1024)
    with index_service.IndexService(raw, profile="azure_ssd",
                                    device="cpu") as svc:
        _serve_some(svc, D.keys, n_batches=3)
        rep = drift.detect_drift(svc, min_queries=16)
    assert rep.recorded_seconds is None
    assert not np.isfinite(rep.ratio) and rep.action == "observe"
    json.dumps(rep.to_dict(), allow_nan=False)


def test_drift_symmetric_on_faster_tier():
    s = ServeStats(queries=1000, modeled_seconds=1.0,
                   walk_modeled_seconds=1.0)
    rep = drift.drift_from_stats(s, recorded_cost=10.0, min_queries=100)
    assert rep.ratio < 1 / 1.25 and rep.drifted and rep.action == "retune"
    assert "action=retune" in rep.describe()


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def generations(tmp_path_factory):
    """Two generations of one key set: gen 0 tuned for azure_ssd, gen 1 a
    warm retune for azure_hdd's observed profile; both written by the
    port, byte-identical to the reference's files."""
    keys = make_keys("fb", 40_000, seed=9)
    pD = KeyPositions.fixed_record(keys, 16)
    root = tmp_path_factory.mktemp("swap")
    paths = [str(root / "gen0.air"), str(root / "gen1.air")]
    g0 = PA.Index.from_design(demo_serving_design(pD),
                              spec=PA.TuneSpec(**SPEC), profile="azure_ssd",
                              **CPU)
    g0.save(paths[0])
    g1 = g0.retune("azure_hdd", warm_start=True).build()
    g1.save(paths[1])
    return keys, paths


def _swap_run(ref, paths, batches, factory=None, **kw):
    IS = ref_is.IndexService if ref else index_service.IndexService
    Spec = RA.ServeSpec if ref else PA.ServeSpec
    extra = {} if ref else {"device": "cpu"}
    svc = IS(paths[0], spec=Spec(**kw), backend_factory=factory, **extra)
    try:
        out = [svc.lookup(b) for b in batches[:3]]
        old = svc.stats
        svc.swap(paths[1])
        out += [svc.lookup(b) for b in batches[3:]]
    finally:
        svc.close()
    return out, old, svc


def test_swap_identical_ranges_and_counters(generations):
    keys, paths = generations
    rng = np.random.default_rng(3)
    batches = [rng.choice(keys, n) for n in (300, 1, 512, 77, 300, 9)]
    kw = dict(backend="numpy", cache_bytes=(16 << 10,), persist_stats=True)
    want, rold, rsvc = _swap_run(True, paths, batches, **kw)
    ref_stats = [ref_is.load_stats_history(p) for p in paths]
    for p in paths:
        os.unlink(stats_path(p))
    got, pold, psvc = _swap_run(False, paths, batches, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _counters(pold) == _counters(rold)
    assert _counters(psvc.stats) == _counters(rsvc.stats)
    assert psvc.stats.swaps == rsvc.stats.swaps == 1
    assert psvc.path == paths[1]
    # each epoch's stats were persisted, on swap and on close
    for p, want_hist in zip(paths, ref_stats):
        hist = load_stats_history(p)
        assert len(hist) == len(want_hist) == 1
        a, b = hist[0]["stats"], want_hist[0]["stats"]
        assert {k: v for k, v in a.items() if k not in WALL_STATS
                and not k.startswith(("roofline", "lookup_p"))} \
            == {k: v for k, v in b.items() if k not in WALL_STATS
                and not k.startswith(("roofline", "lookup_p"))}
        os.unlink(stats_path(p))
    with pytest.raises(RuntimeError, match="closed"):
        psvc.swap(paths[0])


@pytest.mark.parametrize("schedule", ["eio", "persistent"])
def test_swap_under_faults_identical(generations, schedule):
    keys, paths = generations
    rng = np.random.default_rng(4)
    batches = [rng.choice(keys, 200) for _ in range(6)]
    faults = (dict(eio_rate=0.3, eio_attempts=2) if schedule == "eio"
              else dict(eio_rate=1.0, eio_attempts=None))
    outcome, logs = [], []
    for ref, be in ((True, ref_backend), (False, backend)):
        holder = []

        def factory(p, be=be, holder=holder):
            holder.append(be.FaultInjectingBackend(
                be.FileBackend(p), seed=11, page_bytes=1024,
                only_from_offset=0 if p == paths[1] else 1 << 40,
                **faults))
            return holder[-1]

        retry = (RA.RetryPolicy if ref else PA.RetryPolicy)(
            max_attempts=4, backoff_s=1e-5, max_backoff_s=1e-3)
        try:
            out, old, svc = _swap_run(ref, paths, batches, factory,
                                      backend="numpy", retry=retry,
                                      cache_bytes=(16 << 10,))
            outcome.append(("ok", out, _counters(old), _counters(svc.stats)))
        except be.StorageError as e:
            outcome.append((type(e).__name__, vars(e)))
        logs.append([h.fault_log for h in holder])
    assert logs[0] == logs[1]
    if schedule == "eio":
        assert outcome[0][0] == outcome[1][0] == "ok"
        for a, b in zip(outcome[1][1], outcome[0][1]):
            np.testing.assert_array_equal(a, b)
        assert outcome[1][2:] == outcome[0][2:]
    else:
        assert outcome[0][0] != "ok" and outcome[1] == outcome[0]


def test_no_batch_mixes_two_generations(generations):
    keys, paths = generations
    rng = np.random.default_rng(5)
    batches = [rng.choice(keys, 256) for _ in range(40)]
    truth = []
    for p in paths:
        with index_service.IndexService(
                p, device="cpu", spec=PA.ServeSpec(backend="numpy")) as svc:
            truth.append([svc.lookup(b) for b in batches])
    assert any(not np.array_equal(a, b) for a, b in zip(*truth))
    svc = index_service.IndexService(paths[0], device="cpu",
                                     spec=PA.ServeSpec(pipeline_depth=2))
    started = threading.Event()
    result = {}

    def serve():
        started.set()
        result["out"] = svc.lookup_batches(batches)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)        # interleave the two threads finely
    try:
        t = threading.Thread(target=serve)
        t.start()
        assert started.wait(timeout=60)
        svc.swap(paths[1])
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    for i, got in enumerate(result["out"]):
        assert any(np.array_equal(got, gen[i]) for gen in truth), i
    assert svc.stats.swaps == 1
