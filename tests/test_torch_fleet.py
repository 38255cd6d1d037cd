"""The port's sharded fleet against the JAX package's, on the same inputs:
``make_keys("gmm", 40_000, seed=5)`` and ``tests/test_fleet.py``'s tune
and serve specs.  Exact where the reference is: the same shard map and
routes, FleetSpec dicts equal (the port writes its ``"cuda"`` backend as
the reference's ``"pallas"``), the same cache plans (integer allocations
equal, ``predicted_gain`` equal in float64), per-shard designs and costs
equal, shard files and manifests byte-identical, manifests that open in
either package, and lookups bit-identical to the reference's and to
sequential per-shard lookups.  The port's side runs on the CPU
(``device="cpu"``, numpy ranking); the card's case is in
``tests/test_torch_kernel_cuda.py``, which imports only the port."""
import json
import os

import numpy as np
import pytest
import torch

import repro.api as RA
import repro.core as RC
import repro.fleet as RF
import repro.serve as RS
import repro_torch.api as PA
import repro_torch.core as PC
import repro_torch.fleet as PF
import repro_torch.serve as PS
from repro.fleet.budget import ShardDemand as RDemand
from repro_torch.fleet.budget import ShardDemand as PDemand

from conftest import make_keys

TUNE = dict(lam_low=2**8, lam_high=2**14, lam_base=4.0, k=3, max_layers=4,
            page_bytes=1024)
R_SPEC, P_SPEC = RA.TuneSpec(**TUNE), PA.TuneSpec(**TUNE)
# test_fleet.py's FSPEC, and the same fleet naming the device path in
# both packages (the reference's "pallas" is the port's default "cuda"),
# which is what both write into the manifest and every shard file
R_FSPEC = RF.FleetSpec(n_shards=4, tune=R_SPEC,
                       serve=RA.ServeSpec(persist_stats=True))
R_DEVICE_FSPEC = R_FSPEC.replace(serve=R_FSPEC.serve.replace(
    backend="pallas"))
P_FSPEC = PF.FleetSpec(n_shards=4, tune=P_SPEC,
                       serve=PA.ServeSpec(persist_stats=True))
CPU = dict(device="cpu", score_backend="numpy")


@pytest.fixture(scope="module")
def keys():
    return make_keys("gmm", 40_000, seed=5)


@pytest.fixture(scope="module")
def data(keys):
    return RC.KeyPositions.fixed_record(keys, 16), \
        PC.KeyPositions.fixed_record(keys, 16)


@pytest.fixture(scope="module")
def fleets(data, tmp_path_factory):
    """Both packages' fleets, tuned from the same data and saved →
    (reference dir, reference Fleet, port dir, port Fleet)."""
    rd, pd = data
    root = tmp_path_factory.mktemp("fleets")
    ref = RF.Fleet.tune(rd, "azure_ssd", R_DEVICE_FSPEC).build()
    port = PF.Fleet.tune(pd, "azure_ssd", P_FSPEC, **CPU).build()
    ref.save(str(root / "ref"))
    port.save(str(root / "port"))
    return str(root / "ref"), ref, str(root / "port"), port


def _plan_dict(plan):
    return plan.to_dict() if plan is not None else None


# ---------------------------------------------------------------------------
# ShardMap and FleetSpec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_shard_map_bounds_routes_and_slices_equal_the_reference(keys,
                                                                n_shards):
    ref = RF.ShardMap.even_keys(keys, n_shards)
    port = PF.ShardMap.even_keys(keys, n_shards)
    assert port.bounds == ref.bounds and port.n_shards == n_shards
    q = np.random.default_rng(n_shards).choice(keys, 257)
    q = np.concatenate([q, np.array([0, 2**64 - 1], dtype=np.uint64),
                        np.asarray(ref.bounds, dtype=np.uint64)])
    np.testing.assert_array_equal(port.route(q), ref.route(q))
    assert port.slice_bounds(keys) == ref.slice_bounds(keys)
    got, want = port.sub_batches(q), ref.sub_batches(q)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bounds", [(10, 10), (20, 10)])
def test_shard_map_refuses_what_the_reference_refuses(bounds):
    with pytest.raises(ValueError):
        RF.ShardMap(bounds=bounds)
    with pytest.raises(ValueError):
        PF.ShardMap(bounds=bounds)


def test_shard_map_json_opens_in_both_packages():
    ref = RF.ShardMap(bounds=(100, 2**40, 2**63))
    port = PF.ShardMap.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert RF.ShardMap.from_dict(port.to_dict()) == ref


@pytest.mark.parametrize("case", ["test_fleet", "nested", "default"])
def test_fleet_spec_dicts_equal_the_references_modulo_backend(case):
    if case == "test_fleet":
        ref, port = R_FSPEC, P_FSPEC
    elif case == "nested":
        kw = dict(n_shards=8, cache_budget_bytes=1 << 20,
                  budget_quantum=8192)
        ref = RF.FleetSpec(tune=R_SPEC, serve=RA.ServeSpec(
            cache_bytes=(4096,), persist_stats=True), **kw)
        port = PF.FleetSpec(tune=P_SPEC, serve=PA.ServeSpec(
            cache_bytes=(4096,), persist_stats=True), **kw)
    else:
        ref, port = RF.FleetSpec(), PF.FleetSpec()
    assert port.serve.backend == "cuda"
    want = ref.to_dict()
    got = port.to_dict()
    assert got["serve"]["backend"] == "pallas"
    want["serve"]["backend"] = "pallas"
    assert got == want
    assert port.quantum == ref.quantum
    assert PF.FleetSpec.from_json(port.to_json()) == port


def test_fleet_spec_reads_the_references_json_and_back():
    ref = R_FSPEC.replace(cache_budget_bytes=1 << 16)
    port = PF.FleetSpec.from_json(ref.to_json())
    assert port.serve.backend == "numpy"
    assert port.replace(serve=port.serve.replace(backend="cuda")) == \
        P_FSPEC.replace(cache_budget_bytes=1 << 16)
    assert RF.FleetSpec.from_json(port.to_json()) == ref
    device = PF.FleetSpec.from_json(R_DEVICE_FSPEC.to_json())
    assert device.serve.backend == "cuda"
    assert RF.FleetSpec.from_json(device.to_json()) == R_DEVICE_FSPEC


def test_fleet_spec_refuses_unknown_fields_in_both_packages():
    bad = {"n_shards": 2, "cache_budget": 1}
    with pytest.raises(ValueError):
        RF.FleetSpec.from_dict(bad)
    with pytest.raises(ValueError):
        PF.FleetSpec.from_dict(bad)


# ---------------------------------------------------------------------------
# the budget allocator
# ---------------------------------------------------------------------------
ALLOCATIONS = {
    "hot shards first": ([(0, 100.0, 8192), (1, 10.0, 8192),
                          (2, 1.0, 8192)], 12288),
    "never past a working set": ([(0, 5.0, 5000)], 1 << 20),
    "zero working set": ([(0, 100.0, 0)], 1 << 20),
    "budget 0": ([(0, 9.0, 50_000), (1, 3.0, 50_000)], 0),
    "budget 16K": ([(0, 9.0, 50_000), (1, 3.0, 50_000)], 16 << 10),
    "budget 256K": ([(0, 9.0, 50_000), (1, 3.0, 50_000)], 256 << 10),
    "ties": ([(2, 1.0, 4096), (0, 1.0, 4096), (1, 1.0, 4096)], 8192),
}


@pytest.mark.parametrize("case", sorted(ALLOCATIONS))
def test_cache_plans_equal_the_references(case):
    rows, total = ALLOCATIONS[case]
    ref = RF.allocate_cache_budget(
        [RDemand(shard=s, traffic=t, working_set=w, saving=1e-4)
         for s, t, w in rows], total, quantum=4096)
    port = PF.allocate_cache_budget(
        [PDemand(shard=s, traffic=t, working_set=w, saving=1e-4)
         for s, t, w in rows], total, quantum=4096)
    assert port.shares == ref.shares
    assert port.unallocated_bytes == ref.unallocated_bytes
    assert port.predicted_gain == ref.predicted_gain
    assert port.to_dict() == ref.to_dict()


def test_duplicate_shards_refused_in_both_packages():
    for mod, demand in ((RF, RDemand), (PF, PDemand)):
        with pytest.raises(ValueError):
            mod.allocate_cache_budget(
                [demand(shard=0, traffic=1.0, working_set=1, saving=1e-4),
                 demand(shard=0, traffic=2.0, working_set=1, saving=1e-4)],
                4096, quantum=4096)


@pytest.mark.parametrize("alloc,template", [
    (24576, (64 << 10, 512 << 10)), (8192, ()), (12345, (1, 2, 3)),
    (0, (4096,))])
def test_split_cache_tiers_equals_the_reference(alloc, template):
    assert PF.split_cache_tiers(alloc, template, quantum=4096) == \
        RF.split_cache_tiers(alloc, template, quantum=4096)


def test_shard_demands_equal_the_references(fleets):
    _, ref, _, port = fleets
    kw = dict(resident_layers=1)
    for i, (ri, pi) in enumerate(zip(ref.shards, port.shards)):
        rm = RF.demand_from_meta(i, ri.file_meta, RC.PROFILES["azure_ssd"],
                                 cache=RC.PROFILES["host_dram"], **kw)
        pm = PF.demand_from_meta(i, pi.file_meta, PC.PROFILES["azure_ssd"],
                                 cache=PC.PROFILES["host_dram"], **kw)
        assert pm.to_dict() == rm.to_dict()
        rdd = RF.demand_from_design(i, ri.result.design,
                                    RC.PROFILES["azure_ssd"],
                                    cache=RC.PROFILES["host_dram"], **kw)
        pdd = PF.demand_from_design(i, pi.result.design,
                                    PC.PROFILES["azure_ssd"],
                                    cache=PC.PROFILES["host_dram"], **kw)
        assert pdd.to_dict() == rdd.to_dict()


@pytest.mark.parametrize("budget", [0, 4096, 16 << 10, 64 << 10, 1 << 20])
def test_fleet_cache_plans_equal_the_references(fleets, budget):
    _, ref, _, port = fleets
    assert _plan_dict(port.allocate_cache(budget)) == \
        _plan_dict(ref.allocate_cache(budget))


# ---------------------------------------------------------------------------
# the lifecycle: designs, files, manifests
# ---------------------------------------------------------------------------
def test_shard_designs_and_costs_equal_the_references(fleets):
    _, ref, _, port = fleets
    assert port.shard_map == PF.ShardMap(bounds=ref.shard_map.bounds)
    assert port.bases == ref.bases
    assert port.costs == ref.costs
    for ri, pi in zip(ref.shards, port.shards):
        assert pi.result.builder_names == ri.result.builder_names
        rl, pl = ri.result.design.layers, pi.result.design.layers
        assert len(pl) == len(rl)
        for a, b in zip(rl, pl):
            assert a.kind == b.kind and a.size_bytes == b.size_bytes


def test_shard_files_and_manifest_byte_identical(fleets):
    rdir, _, pdir, _ = fleets
    names = sorted(os.listdir(rdir))
    assert sorted(os.listdir(pdir)) == names
    assert "fleet.json" in names and len(names) == 5
    for name in names:
        with open(os.path.join(rdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("direction", ["port opens the reference's",
                                       "reference opens the port's"])
def test_manifest_opens_in_the_other_package(fleets, data, keys, direction):
    rdir, ref, pdir, port = fleets
    rd, pd = data
    if direction.startswith("port"):
        opened = PF.Fleet.open(rdir, data=pd, **CPU)
        twin = port
    else:
        opened = RF.Fleet.open(pdir, data=rd)
        twin = ref
    try:
        assert opened.spec.to_dict() == twin.spec.to_dict()
        assert opened.shard_map.bounds == twin.shard_map.bounds
        assert opened.bases == twin.bases
        assert opened.costs == twin.costs
        q = np.random.default_rng(11).choice(keys, 300)
        np.testing.assert_array_equal(opened.lookup(q), twin.lookup(q))
    finally:
        opened.close()


def test_fleet_open_refuses_data_the_reference_refuses(fleets):
    _, _, pdir, _ = fleets
    other = make_keys("uniform", 10_000, seed=9)
    with pytest.raises(ValueError):
        RF.Fleet.open(pdir, data=RC.KeyPositions.fixed_record(other, 16))
    with pytest.raises(ValueError):
        PF.Fleet.open(pdir, data=PC.KeyPositions.fixed_record(other, 16),
                      **CPU)


# ---------------------------------------------------------------------------
# scatter-gather
# ---------------------------------------------------------------------------
def test_fleet_lookup_equals_the_reference_and_covers_every_key(fleets,
                                                                 data, keys):
    _, ref, _, port = fleets
    rd, _ = data
    q = np.random.default_rng(1).choice(keys, 500)
    got = port.lookup(q)
    np.testing.assert_array_equal(got, ref.lookup(q))
    order = np.searchsorted(rd.keys, q)
    assert (got[:, 0] <= rd.lo[order]).all()
    assert (got[:, 1] >= rd.hi[order]).all()


def test_scatter_gather_bit_identical_to_the_reference_and_sequential(
        fleets, keys):
    _, ref, _, port = fleets
    q = np.random.default_rng(2).choice(keys, 700)
    want = np.empty((len(q), 2), dtype=np.int64)
    for sid, pos in port.shard_map.sub_batches(q):
        with PS.IndexService(port.shards[sid].path, profile="azure_ssd",
                             spec=port.spec.serve.replace(
                                 persist_stats=False),
                             device="cpu") as svc:
            want[pos] = svc.lookup(q[pos]) + port.bases[sid]
    with port.serve(persist_stats=False) as svc:
        got = svc.lookup(q)
    with ref.serve(persist_stats=False, backend="numpy") as svc:
        np.testing.assert_array_equal(got, svc.lookup(q))
    np.testing.assert_array_equal(got, want)


def test_lookup_batches_equal_lookup_and_the_reference(fleets, keys):
    _, ref, _, port = fleets
    rng = np.random.default_rng(3)
    batches = [rng.choice(keys, 128) for _ in range(6)]
    kw = dict(persist_stats=False, pipeline_depth=2, prefetch_layers=2)
    with port.serve(**kw) as svc:
        want = [svc.lookup(b) for b in batches]
        got = svc.lookup_batches(batches)
    with ref.serve(backend="numpy", **kw) as svc:
        ref_got = svc.lookup_batches(batches)
    for w, g, r in zip(want, got, ref_got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)


def test_budgeted_serve_equals_the_references_plan_and_counters(fleets,
                                                                keys):
    _, ref, _, port = fleets
    q = keys[:256]
    with port.serve(total_cache_bytes=64 << 10, persist_stats=False) as svc:
        svc.lookup(q)
        got = svc.stats_summary()
        cache = [s.cache.cap_pages for s in svc.services]
    with ref.serve(total_cache_bytes=64 << 10, persist_stats=False,
                   backend="numpy") as svc:
        svc.lookup(q)
        want = svc.stats_summary()
        assert cache == [s.cache.cap_pages for s in svc.services]
    assert got["plan"] == want["plan"]
    assert got["plan"]["total_bytes"] == 64 << 10
    for k in ("queries", "preads", "bytes_fetched", "hit_rate",
              "query_modeled_us", "walk_query_us", "healthy_shards"):
        assert got[k] == want[k], k
    assert len(got["shards"]) == port.n_shards


def test_persisted_traffic_steers_the_plan_as_in_the_reference(fleets, keys,
                                                              tmp_path):
    """Serving with persisted stats, then allocating: the hot shard's
    observed traffic weights both packages' plans alike."""
    rdir, _, pdir, port = fleets
    q = keys[keys < np.uint64(port.shard_map.bounds[0])]
    plans = []
    for mod, d, kw, serve_kw in ((RF, rdir, {}, {"backend": "numpy"}),
                                 (PF, pdir, CPU, {})):
        dst = tmp_path / mod.__name__
        dst.mkdir()
        for name in os.listdir(d):
            (dst / name).write_bytes(open(os.path.join(d, name), "rb").read())
        fleet = mod.Fleet.open(str(dst), **kw)
        with fleet.serve(**serve_kw) as svc:
            svc.lookup(q[:500])
        plans.append(_plan_dict(fleet.allocate_cache(8192)))
        fleet.close()
    assert plans[0] == plans[1]
    assert plans[0]["demands"][0]["traffic"] == 500.0


# ---------------------------------------------------------------------------
# retunes
# ---------------------------------------------------------------------------
def test_retune_budgeted_equals_the_reference(fleets, data, keys):
    rdir, _, pdir, _ = fleets
    rd, pd = data
    ref = RF.Fleet.open(rdir, data=rd)
    port = PF.Fleet.open(pdir, data=pd, **CPU)
    r2, rplan = ref.retune_budgeted(data=rd, total_cache_bytes=128 << 10)
    p2, pplan = port.retune_budgeted(data=pd, total_cache_bytes=128 << 10)
    assert pplan.to_dict() == rplan.to_dict()
    assert p2.spec.cache_budget_bytes == 128 << 10
    assert p2.build().costs == r2.build().costs
    q = np.random.default_rng(4).choice(keys, 200)
    np.testing.assert_array_equal(p2.lookup(q), r2.lookup(q))
    np.testing.assert_array_equal(p2.lookup(q), port.lookup(q))
    with pytest.raises(ValueError):
        port.retune_budgeted(data=pd)
    with pytest.raises(ValueError):
        ref.retune_budgeted(data=rd)
    ref.close()
    port.close()


def test_retune_for_another_tier_equals_the_reference(fleets, data):
    rdir, _, pdir, _ = fleets
    rd, pd = data
    ref = RF.Fleet.open(rdir, data=rd).retune("azure_nfs", data=rd)
    port = PF.Fleet.open(pdir, data=pd, **CPU).retune("azure_nfs", data=pd)
    assert port.build().costs == ref.build().costs
    assert [i.result.builder_names for i in port.shards] == \
        [i.result.builder_names for i in ref.shards]


def test_cacheable_working_set_equals_the_reference(fleets):
    rdir, _, _, _ = fleets
    path = os.path.join(rdir, "shard_0000.air")
    with RS.IndexService(path) as r, PS.IndexService(path,
                                                     device="cpu") as p:
        rmeta, pmeta = r.meta, p.meta
    L = len(pmeta.layers)
    for res in range(L + 2):
        assert PS.cacheable_working_set(pmeta, res) == \
            RS.cacheable_working_set(rmeta, res)


# ---------------------------------------------------------------------------
# where it runs
# ---------------------------------------------------------------------------
def test_fleet_service_needs_a_card_unless_told_otherwise(fleets,
                                                         monkeypatch):
    _, _, pdir, _ = fleets
    fleet = PF.Fleet.open(pdir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.serve()
    with fleet.serve(device="cpu") as svc:
        assert all(s.device.type == "cpu" for s in svc.services)
    with open(os.path.join(pdir, "fleet.json")) as f:
        assert "device" not in json.dumps(json.load(f))
