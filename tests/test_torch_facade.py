"""The port's ``Index`` facade against the JAX package's: the lifecycle of
``tests/test_api_facade.py`` (tune → save → open → lookup → serve →
retune), byte-identical files from both packages, each package opening
and serving the other's file, warm retunes and seed recovery, and the
repair of the ``persist_stats`` fault (a file the JAX package wrote with
``ServeSpec(persist_stats=True)`` did not open in the port).

Inputs: the repo's ``gmm``/``books``/``fb`` key generators (numpy seeds),
2,000–20,000 keys with 16-byte records; query batches from numpy seeds.
Tolerance: none — designs, costs, ``builder_names``, ``TuneStats``
counters, file bytes and served ranges are identical with numpy ranking.
The port's default ``score_backend="cuda"`` on the CPU ranks with the
float32 plain version; its costs are held to the reference's at rel 1e-6,
the reference's own bound for its device rankers."""
import dataclasses

import numpy as np
import pytest

import repro.api as RA
from repro.core import KeyPositions as RefKP
from repro.core import write_index as ref_write_index
from repro.serve.index_service import demo_serving_design as ref_demo

import repro_torch.api as PA
from repro_torch.api.index import recover_seed_layers
from repro_torch.core import (KeyPositions, LayerBuilder, lookup_batch,
                              materialize_design, outline, verify_lookup,
                              write_index)
from repro_torch.serve import IndexService
from repro_torch.serve.index_service import demo_serving_design

from conftest import make_keys

CPU = dict(device="cpu", score_backend="numpy")


def _specs(**kw):
    base = dict(lam_high=2.0**16, lam_base=4.0, k=3, max_layers=4,
                page_bytes=1024, cache_bytes=(64 << 10, 256 << 10))
    base.update(kw)
    return RA.TuneSpec(**base), PA.TuneSpec(**base)


def _pair(kind="gmm", n=20_000, seed=3):
    keys = make_keys(kind, n, seed)
    return RefKP.fixed_record(keys, 16), KeyPositions.fixed_record(keys, 16)


# ---------------------------------------------------------------------------
# the persist_stats fault: a JAX-written persist_stats file serves in the port
# ---------------------------------------------------------------------------
def test_reference_persist_stats_file_serves_in_the_port(tmp_path):
    keys = make_keys("gmm", 20_000, seed=11)
    rD = RefKP.fixed_record(keys, 16)
    path = str(tmp_path / "persist.air")
    RA.Index.from_design(ref_demo(rD), spec=RA.TuneSpec(page_bytes=1024),
                         profile="azure_ssd").save(
        path, serve_spec=RA.ServeSpec(persist_stats=True))
    q = np.random.default_rng(5).choice(keys, 700)
    ref_svc = RA.Index.open(path).serve()
    try:
        want = ref_svc.lookup(q)
    finally:
        ref_svc.close()
    with IndexService(path, device="cpu") as svc:
        assert svc.spec.persist_stats
        got = svc.lookup(q)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the lifecycle: tune → save → open → lookup → serve
# ---------------------------------------------------------------------------
def _layers_equal(a, b) -> bool:
    if len(a) != len(b):
        return False
    for la, lb in zip(a, b):
        if la.kind != lb.kind:
            return False
        fields = (("piece_keys", "piece_pos", "node_piece_off")
                  if la.kind == "step"
                  else ("node_keys", "x1", "y1", "m", "delta"))
        if not all(np.array_equal(getattr(la, f), getattr(lb, f))
                   for f in fields):
            return False
        if la.kind == "band" and (la.clamp_lo, la.clamp_hi) \
                != (lb.clamp_lo, lb.clamp_hi):
            return False
    return True


def _counters(stats) -> dict:
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(RA.TuneStats)
            if not f.name.endswith("seconds")}


def _same_result(port, ref, exact=True):
    assert port.builder_names == ref.builder_names
    assert _layers_equal(port.design.layers, ref.design.layers)
    assert port.strategy == ref.strategy and port.objective == ref.objective
    if exact:
        assert port.cost == ref.cost
        assert _counters(port.stats) == _counters(ref.stats)
    else:
        assert port.cost == pytest.approx(ref.cost, rel=1e-6)


@pytest.mark.parametrize("kind,families", [
    ("gmm", None), ("books", None), ("gmm", ("btree", "pgm", "gstep"))])
def test_lifecycle_writes_byte_identical_files(tmp_path, kind, families):
    rD, pD = _pair(kind)
    rspec, pspec = _specs(**({"families": families} if families else {}))
    ridx = RA.Index.tune(rD, "azure_ssd", rspec).build()
    pidx = PA.Index.tune(pD, "azure_ssd", pspec, **CPU).build()
    _same_result(pidx.result, ridx.result)
    rpath, ppath = str(tmp_path / "ref.air"), str(tmp_path / "port.air")
    ridx.save(rpath, serve_spec=RA.ServeSpec(backend="pallas"))
    pidx.save(ppath, serve_spec=PA.ServeSpec())
    with open(rpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    qs = np.random.default_rng(0).choice(pD.keys, 500)
    mem = lookup_batch(pidx.design, qs)
    np.testing.assert_array_equal(pidx.lookup(qs)[:, 0], mem.lo)
    np.testing.assert_array_equal(pidx.lookup(qs), ridx.lookup(qs))
    re = PA.Index.open(ppath, device="cpu")
    assert re.spec == pspec and re.file_meta.tune["strategy"] == "airtune"
    assert re.cost == ridx.cost and re.describe() == \
        RA.Index.open(rpath).describe().replace("ref.air", "port.air")
    with re.serve() as svc:
        assert svc.profile == PA.PROFILES["azure_ssd"]
        assert svc.spec.backend == "cuda" and svc.device.type == "cpu"
        got = svc.lookup(qs)
    np.testing.assert_array_equal(got[:, 0], mem.lo)
    np.testing.assert_array_equal(got[:, 1], mem.hi)
    with PA.Index.open(ppath) as disk:
        np.testing.assert_array_equal(disk.lookup(qs), got)
    assert verify_lookup(PA.Index.open(ppath, data=pD).design, qs)


def test_cuda_ranking_on_the_cpu_tunes_the_reference_design():
    rD, pD = _pair("gmm", n=15_000)
    rspec, pspec = _specs()
    ref = RA.Index.tune(rD, "azure_ssd", rspec).build().result
    port = PA.Index.tune(pD, "azure_ssd", pspec, device="cpu").build()
    assert port.result.stats.est_batches > 0      # ranked by the plain version
    _same_result(port.result, ref, exact=False)
    # device and score_backend never enter the file meta
    assert "device" not in port.spec.to_dict()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_opens_and_serves_the_others_file(tmp_path, writer):
    rD, pD = _pair("fb", n=12_000)
    rspec, pspec = _specs()
    path = str(tmp_path / f"{writer}.air")
    if writer == "reference":
        RA.Index.tune(rD, "azure_hdd", rspec).save(
            path, serve_spec=RA.ServeSpec(backend="pallas",
                                          resident_layers=2))
    else:
        PA.Index.tune(pD, "azure_hdd", pspec, **CPU).save(
            path, serve_spec=PA.ServeSpec(resident_layers=2))
    qs = np.random.default_rng(9).choice(pD.keys, 400)
    rix, pix = RA.Index.open(path, data=rD), PA.Index.open(path, data=pD,
                                                           device="cpu")
    assert pix.spec.to_dict() == rix.spec.to_dict()
    assert pix.serve_spec.backend == "cuda" \
        and rix.serve_spec.backend == "pallas"
    assert pix.profile == PA.PROFILES["azure_hdd"] and pix.cost == rix.cost
    np.testing.assert_array_equal(pix.lookup(qs), rix.lookup(qs))
    assert _layers_equal(pix.design.layers, rix.design.layers)
    with pix.serve() as psvc:
        got = psvc.lookup(qs)
        assert psvc.spec.resident_layers == 2 and psvc.tune_spec == pix.spec
    rsvc = rix.serve()
    try:
        want = rsvc.lookup(qs)
    finally:
        rsvc.close()
    np.testing.assert_array_equal(got, want)


def test_materialize_design_identical(tmp_path):
    from repro.core.serialize import materialize_design as ref_materialize
    rD, pD = _pair("books", n=10_000)
    path = str(tmp_path / "m.air")
    ref_write_index(path, ref_demo(rD), page_bytes=1024)
    assert _layers_equal(materialize_design(path, pD).layers,
                         ref_materialize(path, rD).layers)
    d = materialize_design(path, pD).layers
    assert [type(x).__name__ for x in d] == ["StepLayer", "BandLayer",
                                             "StepLayer"]


def test_disk_opened_index_never_researches(tmp_path):
    _, pD = _pair(n=10_000)
    _, pspec = _specs()
    idx = PA.Index.from_design(demo_serving_design(pD), spec=pspec,
                               profile="azure_ssd", **CPU)
    assert idx.result.strategy == "manual" and np.isfinite(idx.cost)
    path = str(tmp_path / "d.air")
    idx.save(path)
    re = PA.Index.open(path, data=pD)
    assert re.design.n_layers == 3 and re.cost == pytest.approx(idx.cost)
    assert re.build() is re
    with pytest.raises(ValueError, match="opened from disk"):
        _ = re.result
    with pytest.raises(ValueError, match="opened from disk"):
        re.save(str(tmp_path / "clobber.air"))
    assert "strategy=manual" in re.describe()
    with pytest.raises(ValueError, match="data"):
        _ = PA.Index.open(path).design
    fresh = re.retune("azure_ssd", data=pD, **CPU)
    assert fresh.path is None and fresh.result.strategy == "airtune"
    with pytest.raises(ValueError, match="save"):
        PA.Index.tune(pD, "azure_ssd", pspec, **CPU).serve()
    with pytest.raises(KeyError, match="azure_ssd"):
        PA.Index.tune(pD, "not_a_tier")
    unbuilt = PA.Index.tune(pD, "azure_ssd", pspec)
    assert "unbuilt" in unbuilt.describe() and unbuilt._result is None


def test_save_page_bytes_override_and_strict_json(tmp_path):
    _, pD = _pair(n=3_000)
    _, pspec = _specs()
    path = str(tmp_path / "o.air")
    PA.Index.tune(pD, "azure_ssd", pspec, **CPU).save(path, page_bytes=2048)
    re = PA.Index.open(path)
    assert re.file_meta.page_bytes == 2048
    assert re.spec == pspec.replace(page_bytes=2048)
    nan_path = str(tmp_path / "nan.air")
    PA.Index.from_design(demo_serving_design(pD), spec=pspec).save(nan_path)
    assert PA.Index.open(nan_path).file_meta.tune["cost"] is None
    assert np.isnan(PA.Index.open(nan_path).cost)


# ---------------------------------------------------------------------------
# warm retune and seed recovery
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ranking", ["numpy", "plain"])
@pytest.mark.parametrize("strategy", ["airtune", "beam"])
def test_warm_retune_matches_reference(tmp_path, ranking, strategy):
    rD, pD = _pair("gmm", n=15_000, seed=5)
    rspec, pspec = _specs(strategy=strategy)
    kw = CPU if ranking == "numpy" else dict(device="cpu")
    ridx = RA.Index.tune(rD, "azure_ssd", rspec).build()
    pidx = PA.Index.tune(pD, "azure_ssd", pspec, **kw).build()
    exact = ranking == "numpy"
    _same_result(pidx.result, ridx.result, exact)
    for tier in ("azure_hdd", "azure_nfs"):
        rw = ridx.retune(tier, warm_start=True).build()
        pw = pidx.retune(tier, warm_start=True).build()
        _same_result(pw.result, rw.result, exact)
        assert pw.stats.layers_seeded == rw.stats.layers_seeded > 0
        assert pw.stats.layers_reused == rw.stats.layers_reused
    # from disk: the seed is recovered from the file
    rpath, ppath = str(tmp_path / "r.air"), str(tmp_path / "p.air")
    ridx.save(rpath)
    pidx.save(ppath)
    rw = RA.Index.open(rpath, data=rD).retune("azure_hdd",
                                              warm_start=True).build()
    pw = PA.Index.open(ppath, data=pD, **kw).retune(
        "azure_hdd", warm_start=True).build()
    _same_result(pw.result, rw.result, exact)
    assert pw.stats.layers_seeded == rw.stats.layers_seeded > 0


def test_recover_seed_layers_identical(tmp_path):
    from repro.api.index import recover_seed_layers as ref_recover
    from repro.core.builders import LayerBuilder as RefBuilder
    from repro.core.serialize import materialize_design as ref_materialize
    keys = make_keys("books", 30_000, seed=4)
    rD, pD = RefKP.fixed_record(keys, 16), KeyPositions.fixed_record(keys, 16)
    b1, b2 = LayerBuilder(kind="gband", lam=2**9), \
        LayerBuilder(kind="gstep", lam=2**7, p=8)
    l1 = b1(pD)
    l2 = b2(outline(l1, pD))
    path = str(tmp_path / "two.air")
    from repro_torch.core import IndexDesign
    write_index(path, IndexDesign(layers=(l1, l2), data=pD), page_bytes=1024)
    rb1, rb2 = RefBuilder(kind="gband", lam=2**9), \
        RefBuilder(kind="gstep", lam=2**7, p=8)
    for names in ((b1.name, b2.name), (b1.name, "ThirdParty(9)")):
        got = recover_seed_layers(names, materialize_design(path, pD).layers,
                                  [b1, b2], pD)
        want = ref_recover(names, ref_materialize(path, rD).layers,
                           [rb1, rb2], rD)
        assert [n for n, _ in got] == [n for n, _ in want]
        assert _layers_equal([x for _, x in got], [x for _, x in want])
    r1, r2 = (x for _, x in recover_seed_layers(
        (b1.name, b2.name), materialize_design(path, pD).layers, [b1, b2],
        pD))
    assert (r1.clamp_lo, r1.clamp_hi) == (l1.clamp_lo, l1.clamp_hi)
    assert np.array_equal(r2.node_piece_off, l2.node_piece_off)
