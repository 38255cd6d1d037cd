"""The JAX package's deprecated entry points and layer checks, in the
port: ``core.load_index``, ``core.lookup.lookup_file``, ``IndexService``'s
pre-spec keywords and ``fd``, ``Index.serve(use_device=...)``, and
``StepLayer.piece_widths`` / ``validate_against`` (Eq. 1).

Inputs: the repo's ``gmm`` and ``books`` key generators (numpy seeds),
16-byte records, one index file that the JAX package writes and both
packages read, query batches from numpy seed 5.  Tolerance: none — the
shims delegate to the facade in both packages, whose float64 numpy walks
are bit-identical; layer widths and Eq. (1) checks are float64 numpy.

The JAX package's ``pyproject.toml`` escalates only ``repro.*``
deprecation warnings to errors, so the port's warnings are caught with
``pytest.warns`` and its internal-use error is tested directly.  Each
test starts from an empty warn-once memory (``deprecation._WARNED``)."""
import warnings

import numpy as np
import pytest

import repro.api as RA
import repro.core as RC
from repro.core import lookup as rlookup
from repro.core.registry import BUILDER_FAMILIES as REF_FAMILIES
from repro.serve.index_service import IndexService as RefService
from repro.serve.index_service import demo_serving_design as ref_demo

import repro_torch.api as PA
import repro_torch.core as PC
from repro_torch.core import deprecation
from repro_torch.core import lookup as plookup
from repro_torch.core.registry import BUILDER_FAMILIES
from repro_torch.serve import IndexService

from conftest import make_keys


@pytest.fixture(autouse=True)
def fresh_warn_once(monkeypatch):
    monkeypatch.setattr(deprecation, "_WARNED", set())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A paged index file the JAX package writes, its data layer and 700
    queries."""
    keys = make_keys("gmm", 20_000, seed=11)
    path = str(tmp_path_factory.mktemp("shims") / "idx.air")
    RA.Index.from_design(ref_demo(RC.KeyPositions.fixed_record(keys, 16)),
                         spec=RA.TuneSpec(page_bytes=1024),
                         profile="azure_ssd").save(path)
    return path, keys, np.random.default_rng(5).choice(keys, 700)


def _ref(call):
    """A reference shim's result; its warning (an error under the repo's
    filter) is recorded instead."""
    with pytest.warns(DeprecationWarning, match=r"repro\."):
        return call()


def _same_design(a, b):
    assert len(a.layers) == len(b.layers)
    for x, y in zip(a.layers, b.layers):
        assert x.kind == y.kind
        for f in ("piece_keys", "piece_pos", "node_piece_off", "node_keys",
                  "x1", "y1", "m", "delta"):
            if hasattr(y, f) and not callable(getattr(y, f)):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_load_index_is_the_facades_design(written):
    path, keys, _ = written
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.core\.load_index\(path, data\)"):
        got = PC.load_index(path, PC.KeyPositions.fixed_record(keys, 16))
    want = _ref(lambda: RC.load_index(
        path, RC.KeyPositions.fixed_record(keys, 16)))
    _same_design(got, want)
    _same_design(got, PA.Index.open(path, data=PC.KeyPositions.fixed_record(
        keys, 16)).design)
    assert PC.load_index is PC.serialize.load_index


def test_lookup_file_is_the_facades_lookup(written):
    path, _, q = written
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.core\.lookup\.lookup_file"):
        got = plookup.lookup_file(path, None, q)
    want = _ref(lambda: rlookup.lookup_file(path, None, q))
    np.testing.assert_array_equal(got, want)
    with PA.Index.open(path) as idx:
        np.testing.assert_array_equal(got, idx.lookup(q))


LEGACY = dict(cache_bytes=(64 << 10, 1 << 20), cache_profile="host_dram",
              page_bytes=1024, resident_layers=2, use_device=False,
              interpret=True, coalesce_gap=4096, persist_stats=False)


def test_legacy_keywords_fold_into_the_spec_and_warn_once_each(written):
    path, _, q = written
    with pytest.warns(DeprecationWarning) as rec:
        svc = IndexService(path, device="cpu", **LEGACY)
    msgs = sorted(str(w.message) for w in rec)
    assert msgs == sorted(
        f"repro_torch.serve.IndexService({k}=...) is deprecated; pass "
        f"spec=repro_torch.api.ServeSpec(...) instead" for k in LEGACY)
    want_spec = PA.ServeSpec(cache_bytes=(64 << 10, 1 << 20),
                             cache_profile="host_dram", page_bytes=1024,
                             resident_layers=2, backend="numpy",
                             interpret=True, coalesce_gap=4096,
                             persist_stats=False).validate()
    with svc:
        assert svc.spec == want_spec
        got, stats = svc.lookup(q), svc.stats
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = RefService(path, **LEGACY)
    with ref:
        want, ref_stats = ref.lookup(q), ref.stats
    np.testing.assert_array_equal(got, want)
    assert (stats.preads, stats.pages_hit, stats.bytes_fetched) == \
        (ref_stats.preads, ref_stats.pages_hit, ref_stats.bytes_fetched)
    # once per keyword: a second open warns no more
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        IndexService(path, device="cpu", use_device=True).close()


def test_use_device_maps_to_the_backends(written):
    path, _, q = written
    with pytest.warns(DeprecationWarning, match="use_device"):
        on = IndexService(path, device="cpu", use_device=True)
    off = IndexService(path, device="cpu", use_device=False)
    with on, off:
        assert on.spec.backend == "cuda" and off.spec.backend == "numpy"
        np.testing.assert_array_equal(on.lookup(q), off.lookup(q))
    with pytest.raises(TypeError, match="unexpected keyword"):
        IndexService(path, device="cpu", cache_size=3)


def test_index_serve_use_device(written):
    path, _, q = written
    idx = PA.Index.open(path, device="cpu")
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.serve\.Index\.serve\(use_device"):
        svc = idx.serve(use_device=False)
    with svc, idx.serve(use_device=True) as dev:
        assert svc.spec.backend == "numpy" and dev.spec.backend == "cuda"
        np.testing.assert_array_equal(svc.lookup(q), dev.lookup(q))


def test_fd_is_the_file_backends_descriptor(written):
    path, _, _ = written
    svc = IndexService(path, device="cpu")
    assert isinstance(svc.fd, int) and svc.fd == svc.storage.fd
    svc.close()
    assert svc.fd is None
    ref = RefService(path)
    assert isinstance(ref.fd, int)
    ref.close()
    assert ref.fd is None


def _inside_the_port(src: str, **names):
    """Run ``src`` as if it were code of a ``repro_torch`` module."""
    ns = {"__name__": "repro_torch.fake_caller", **names}
    exec(compile(src, "<repro_torch>", "exec"), ns)
    return ns["call"]


def test_a_call_from_inside_the_port_raises(written):
    path, keys, q = written
    D = PC.KeyPositions.fixed_record(keys, 16)
    calls = [
        _inside_the_port("def call(): return load_index(path, D)",
                         load_index=PC.load_index, path=path, D=D),
        _inside_the_port("def call(): return lookup_file(path, None, q)",
                         lookup_file=plookup.lookup_file, path=path, q=q),
        _inside_the_port("def call(): return IndexService(path, "
                         "device='cpu', use_device=False)",
                         IndexService=IndexService, path=path),
        _inside_the_port("def call(): return idx.serve(use_device=False)",
                         idx=PA.Index.open(path, device="cpu")),
    ]
    for call in calls:
        for _ in range(2):           # warned before or not: always raises
            with pytest.raises(AssertionError,
                               match="deprecated API used from within "
                                     "repro_torch"):
                call()


FAMILIES = [("gstep", 256.0, 16), ("gband", 1024.0, 16),
            ("eband", 1024.0, 16), ("btree", 4096.0, 16),
            ("rmi_leaf", 1024.0, 16), ("pgm", 512.0, 0)]


@pytest.mark.parametrize("kind", ["gmm", "books"])
@pytest.mark.parametrize("fam,lam,p", FAMILIES)
def test_every_familys_layer_passes_eq1_as_the_reference(kind, fam, lam, p):
    keys = make_keys(kind, 5_000, seed=7)
    got = BUILDER_FAMILIES.get(fam)(PC.KeyPositions.fixed_record(keys, 16),
                                    lam, p)
    want = REF_FAMILIES.get(fam)(RC.KeyPositions.fixed_record(keys, 16),
                                 lam, p)
    got.validate_against(PC.KeyPositions.fixed_record(keys, 16))
    want.validate_against(RC.KeyPositions.fixed_record(keys, 16))
    assert got.kind == want.kind
    if got.kind == "step":
        w = got.piece_widths()
        assert w.dtype == np.float64
        np.testing.assert_array_equal(w, want.piece_widths())


def _broken(layer):
    """The layer with every prediction one record too narrow."""
    import dataclasses
    if layer.kind == "step":
        return dataclasses.replace(layer, piece_pos=layer.piece_pos + 16)
    return dataclasses.replace(layer, delta=np.maximum(layer.delta - 64, 0))


@pytest.mark.parametrize("fam,lam,p", FAMILIES)
def test_a_layer_that_breaks_eq1_fails_as_the_reference(fam, lam, p):
    keys = make_keys("gmm", 5_000, seed=3)
    got = _broken(BUILDER_FAMILIES.get(fam)(
        PC.KeyPositions.fixed_record(keys, 16), lam, p))
    want = _broken(REF_FAMILIES.get(fam)(
        RC.KeyPositions.fixed_record(keys, 16), lam, p))
    msgs = []
    for layer, KP in ((got, PC.KeyPositions), (want, RC.KeyPositions)):
        with pytest.raises(AssertionError) as err:
            layer.validate_against(KP.fixed_record(keys, 16))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f"{got.kind} layer violates Eq. (1)"
