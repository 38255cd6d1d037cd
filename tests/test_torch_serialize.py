"""The port's index file format, builders and keysets against the JAX
package's.  Inputs: the repo's ``gmm``/``fb`` key generators (numpy
seeds) with 16-byte records.  Tolerance: none — files are byte-identical,
metas equal, arrays and lookup ranges bit-identical."""
import dataclasses

import numpy as np
import pytest

from repro.core import IndexDesign as RefDesign
from repro.core import KeyPositions as RefKP
from repro.core import SerializedIndex as RefSerialized
from repro.core import write_index as ref_write_index
from repro.core import builders as ref_builders
from repro.core import descent as ref_descent
from repro.core import serialize as ref_ser
from repro.core.nodes import mean_width as ref_mean_width
from repro.core.nodes import outline as ref_outline
from repro.serve.index_service import demo_serving_design as ref_demo

from repro_torch.core import (KeyPositions, SerializedIndex,
                              design_from_arrays, read_meta_path,
                              write_index)
from repro_torch.core import builders, descent, serialize
from repro_torch.core.nodes import mean_width, outline
from repro_torch.serve import demo_serving_design

from conftest import make_keys

MIXES = {
    "step-band-step": (("gstep", 2**10), ("gband", 2**9), ("gstep", 2**7)),
    "band-eband-step": (("gband", 2**10), ("eband", 2**9), ("gstep", 2**7)),
    "gstep2": (("gstep", 2**9), ("gstep", 2**8)),
}


def _build(mod, D, mix, outline_fn, design_cls):
    layers, cur = [], D
    for kind, lam in mix:
        if kind == "gstep":
            lay = mod.build_gstep(cur, 8, lam)
        elif kind == "gband":
            lay = mod.build_gband(cur, lam)
        else:
            lay = mod.build_eband(cur, lam)
        layers.append(lay)
        cur = outline_fn(lay, cur)
    return design_cls(layers=tuple(layers), data=D)


def _arrays(design):
    """A reference design as the plain arrays design_from_arrays takes."""
    layers = []
    for lay in design.layers:
        if lay.kind == "step":
            layers.append({"kind": "step", "piece_keys": lay.piece_keys,
                           "piece_pos": lay.piece_pos,
                           "node_piece_off": lay.node_piece_off})
        else:
            layers.append({"kind": "band", "node_keys": lay.node_keys,
                           "x1": lay.x1, "y1": lay.y1, "m": lay.m,
                           "delta": lay.delta, "clamp_lo": lay.clamp_lo,
                           "clamp_hi": lay.clamp_hi})
    D = design.data
    return layers, {"keys": D.keys, "lo": D.lo, "hi": D.hi,
                    "weights": D.weights}


@pytest.fixture(scope="module")
def data():
    keys = make_keys("gmm", 40_000, seed=3)
    return keys, RefKP.fixed_record(keys, 16), KeyPositions.fixed_record(keys, 16)


@pytest.fixture(scope="module")
def ref_designs(data):
    _, D, _ = data
    return {name: _build(ref_builders, D, mix, ref_outline, RefDesign)
            for name, mix in MIXES.items()}


LAYOUTS = {"dense": dict(page_bytes=0),
           "paged_crc": dict(page_bytes=4096),
           "paged_1k_crc": dict(page_bytes=1024),
           "paged_no_crc": dict(page_bytes=4096, checksums=False)}


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_carried_design_writes_byte_identical_file(ref_designs, tmp_path,
                                                   name, layout):
    kw = LAYOUTS[layout]
    want = str(tmp_path / "ref.air")
    got = str(tmp_path / "port.air")
    ref_write_index(want, ref_designs[name], data_record=16, **kw)
    design = design_from_arrays(*_arrays(ref_designs[name]))
    write_index(got, design, data_record=16, **kw)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", sorted(MIXES))
def test_port_builders_write_byte_identical_file(data, ref_designs, tmp_path,
                                                 name):
    _, _, D = data
    from repro_torch.core import IndexDesign
    design = _build(builders, D, MIXES[name], outline, IndexDesign)
    want, got = str(tmp_path / "ref.air"), str(tmp_path / "port.air")
    ref_write_index(want, ref_designs[name], page_bytes=4096,
                    tune={"note": "provenance"})
    write_index(got, design, page_bytes=4096, tune={"note": "provenance"})
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    assert design.describe() == ref_designs[name].describe()
    outs, ref_outs = design.outlines(), ref_designs[name].outlines()
    for lay, rlay, o, ro in zip(design.layers, ref_designs[name].layers,
                                outs, ref_outs):
        assert mean_width(lay, o) == ref_mean_width(rlay, ro)


@pytest.mark.parametrize("lam", [64.0, 1000.0, 2.0**12])
@pytest.mark.parametrize("switch", [4, 8192])
def test_greedy_partition_identical(data, lam, switch):
    _, D, _ = data
    np.testing.assert_array_equal(
        builders.greedy_partition(D.lo_f, D.hi_f, lam, switch=switch),
        ref_builders.greedy_partition(D.lo_f, D.hi_f, lam, switch=switch))


def test_demo_serving_design_identical(data, tmp_path):
    _, rD, D = data
    want, got = str(tmp_path / "ref.air"), str(tmp_path / "port.air")
    ref_write_index(want, ref_demo(rD), page_bytes=4096)
    write_index(got, demo_serving_design(D), page_bytes=4096)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_each_package_parses_the_others_file(ref_designs, tmp_path, layout):
    design = ref_designs["step-band-step"]
    rpath, ppath = str(tmp_path / "ref.air"), str(tmp_path / "port.air")
    ref_write_index(rpath, design, **LAYOUTS[layout])
    write_index(ppath, design_from_arrays(*_arrays(design)),
                **LAYOUTS[layout])
    for path in (rpath, ppath):
        ref_meta = ref_ser.read_meta_path(path)
        port_meta = read_meta_path(path)
        assert port_meta.to_json() == ref_meta.to_json()
        assert dataclasses.asdict(port_meta) == dataclasses.asdict(ref_meta)


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("page_bytes", [0, 4096])
def test_serialized_lookups_identical(data, ref_designs, tmp_path, name,
                                      page_bytes):
    keys, _, _ = data
    path = str(tmp_path / "idx.air")
    ref_write_index(path, ref_designs[name], page_bytes=page_bytes)
    rng = np.random.default_rng(7)
    qs = np.concatenate([rng.choice(keys, 200),
                         rng.integers(1, int(keys[-1]) + 10, 50)
                         .astype(np.uint64)])
    a, b = RefSerialized(path), SerializedIndex(path)
    try:
        for q in qs:
            assert b.lookup(int(q)) == a.lookup(int(q))
        assert (b.reads, b.bytes_read) == (a.reads, a.bytes_read)
    finally:
        a.close()
        b.close()
    np.testing.assert_array_equal(serialize.lookup_serialized(path, None, qs),
                                  ref_ser.lookup_serialized(path, None, qs))


@pytest.mark.parametrize("kind", ["step", "band"])
@pytest.mark.parametrize("seed", [0, 1])
def test_record_helpers_identical(kind, seed):
    rng = np.random.default_rng(seed)
    lo = rng.integers(-50, 5000, 300)
    hi = lo + rng.integers(-5, 900, 300)
    for size in (16 * 40, 40 * 31, 4096):
        a, b = serialize.record_aligned_range(kind, lo, hi, size)
        ra, rb = ref_ser.record_aligned_range(kind, lo, hi, size)
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(b, rb)
    off = rng.integers(0, 10**6, 300)
    sz = rng.integers(0, 10**4, 300)
    for pb in (1024, 4096):
        for x, y in zip(serialize.page_span(off, sz, pb),
                        ref_ser.page_span(off, sz, pb)):
            np.testing.assert_array_equal(x, y)
    blob = rng.integers(0, 256, 10_000).astype(np.uint8).tobytes()
    assert serialize.layer_page_crcs(blob, 1024) == \
        ref_ser.layer_page_crcs(blob, 1024)
    assert serialize.gallop_step(kind, 80, 80) == \
        ref_ser.gallop_step(kind, 80, 80)
    dt = serialize._STEP_DT if kind == "step" else serialize._BAND_DT
    assert dt == (ref_ser._STEP_DT if kind == "step" else ref_ser._BAND_DT)
    rec = np.zeros(20, dtype=dt)
    rec["key" if kind == "step" else "x1"] = np.sort(
        rng.choice(10**6, 20, replace=False))
    raw = rec.tobytes()
    q = rng.integers(0, 10**6 + 10, 64).astype(np.uint64)
    for x, y in zip(serialize.window_misses(kind, raw, 16, 800, 5000, q),
                    ref_ser.window_misses(kind, raw, 16, 800, 5000, q)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(serialize.predict_from_records(kind, raw, q, 99_999),
                    ref_ser.predict_from_records(kind, raw, q, 99_999)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("gap", [0, 1, 100])
def test_coalesce_and_covering_identical(gap):
    rng = np.random.default_rng(gap)
    s = rng.integers(0, 10**5, 500)
    e = s + rng.integers(1, 3000, 500)
    for x, y in zip(descent.coalesce_ranges(s, e, gap),
                    ref_descent.coalesce_ranges(s, e, gap)):
        np.testing.assert_array_equal(x, y)
    keys = np.unique(rng.integers(0, 10**6, 300)).astype(np.uint64)
    q = rng.integers(0, 10**6, 1000).astype(np.uint64)
    np.testing.assert_array_equal(descent.covering_index(keys, q),
                                  ref_descent.covering_index(keys, q))


def test_keypositions_identical(data):
    keys, rD, D = data
    assert D.fingerprint == rD.fingerprint
    assert (D.n, D.size_bytes, D.total_weight) == \
        (rD.n, rD.size_bytes, rD.total_weight)
    np.testing.assert_array_equal(D.mid_f, rD.mid_f)
    D.validate()
    s, rs = D.slice(100, 900), rD.slice(100, 900)
    assert s.fingerprint == rs.fingerprint
    offs = np.concatenate([[0], np.cumsum(np.arange(1, len(keys) + 1))])
    assert KeyPositions.from_offsets(keys, offs).fingerprint == \
        RefKP.from_offsets(keys, offs).fingerprint


# ---------------------------------------------------------------------------
# tuning and serving specs in the meta: each package serves the other's file
# ---------------------------------------------------------------------------
def _ranges_both(path, q):
    """The same batch through the port's engine on the CPU and through the
    reference's facade, each configured from the file's recorded specs."""
    from repro.api import Index as RefIndex
    from repro_torch.serve import IndexService

    with IndexService(path, device="cpu") as svc:
        port = svc.lookup(q)
        port_spec = svc.spec
    ref_svc = RefIndex.open(path).serve()
    try:
        ref = ref_svc.lookup(q)
        ref_spec = ref_svc.spec
    finally:
        ref_svc.close()
    return port, ref, port_spec, ref_spec


def test_port_written_specs_serve_in_the_reference(data, tmp_path):
    from repro_torch.api import ServeSpec, TuneSpec

    keys, _, D = data
    path = str(tmp_path / "port.air")
    meta = write_index(path, demo_serving_design(D), page_bytes=4096,
                       tune={"spec": TuneSpec().to_dict(),
                             "serve": ServeSpec().to_dict()})
    assert meta.tune["serve"]["backend"] == "pallas"
    q = keys[np.random.default_rng(7).integers(0, len(keys), 3000)]
    port, ref, port_spec, ref_spec = _ranges_both(path, q)
    assert port_spec.backend == "cuda" and ref_spec.backend == "pallas"
    np.testing.assert_array_equal(port, ref)
    idx = np.searchsorted(keys, q)
    assert np.all((port[:, 0] <= 16 * idx) & (port[:, 1] >= 16 * idx + 16))


def test_reference_written_specs_serve_in_the_port(data, tmp_path):
    from repro.api import ServeSpec as RefServeSpec
    from repro.api import TuneSpec as RefTuneSpec
    from repro_torch.api import ServeSpec, TuneSpec

    keys, rD, _ = data
    path = str(tmp_path / "ref.air")
    tune_spec = RefTuneSpec(families=("btree", "gstep"), k=3,
                            cache_bytes=(1 << 16,), objective={"p": 0.99})
    serve_spec = RefServeSpec(backend="pallas", resident_layers=2,
                              cache_bytes=(1 << 16, 1 << 20))
    ref_write_index(path, ref_demo(rD), page_bytes=4096,
                    tune={"spec": tune_spec.to_dict(),
                          "serve": serve_spec.to_dict()})
    meta = read_meta_path(path)
    assert TuneSpec.from_dict(meta.tune["spec"]).to_dict() \
        == tune_spec.to_dict()
    assert ServeSpec.from_dict(meta.tune["serve"]).to_dict() \
        == serve_spec.to_dict()
    q = keys[np.random.default_rng(8).integers(0, len(keys), 3000)]
    port, ref, port_spec, ref_spec = _ranges_both(path, q)
    assert port_spec.backend == "cuda" and port_spec.resident_layers == 2
    assert ref_spec == serve_spec
    np.testing.assert_array_equal(port, ref)
