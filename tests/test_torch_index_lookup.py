"""The port's batched index lookup (the in-memory Alg. 1) against the JAX
package's ``repro.kernels.index_lookup`` and ``repro.core.lookup``.

Inputs: numpy-seeded sorted int32 keys and positions on the matrix of the
JAX package's ``tests/test_kernels.py`` (step (P, Q) ∈ {(64, 32),
(1000, 777), (4096, 1024), (20000, 513)}, band (N, Q) ∈ {(10, 64),
(300, 300), (4096, 512)}) plus single and ragged batches and queries
below the first key, above the last and equal to keys; the tuned design
of that file; ``gmm``/``books`` designs for ``lookup_batch``.  The JAX
side runs its Pallas kernels in interpret mode, the port's its plain
PyTorch versions (``device="cpu"``).  Tolerance: step results exact; band
results within 4 (the JAX package's own bound: its kernel and oracle
differ by FMA contraction); planes, ``lookup_batch`` and
``verify_lookup`` bit-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.lookup import lookup_batch as ref_lookup_batch
from repro.core.lookup import verify_lookup as ref_verify_lookup
from repro.kernels.index_lookup import ops as ref_ops
from repro.kernels.index_lookup import ref as ref_ref

import repro_torch.core as P
from repro_torch.kernels import index_lookup as il
from repro_torch.kernels.index_lookup import kernel as K

from conftest import make_keys

I32_TOP = 2**31 - 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_case(seed, P_, Q, extra):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(2**26, P_, replace=False)).astype(np.int32)
    pos = np.sort(rng.choice(2**28, P_ + 1, replace=False)).astype(np.int32)
    q = rng.integers(0, 2**26, Q).astype(np.int32)
    if extra:
        q = np.concatenate([q, [0, keys[0] - 1, keys[0], keys[-1],
                                keys[-1] + 1, I32_TOP],
                            rng.choice(keys, 7)]).astype(np.int32)
    return q, keys, pos


STEP_CASES = [(64, 32, False), (1000, 777, False), (4096, 1024, False),
              (20_000, 513, False), (64, 1, False), (1000, 257, True),
              (4096, 257, True), (20_000, 1, False), (20_000, 257, True),
              (4097, 300, True), (1, 9, True)]


@pytest.mark.parametrize("P_,Q,extra", STEP_CASES)
def test_step_layer_matches_reference(P_, Q, extra):
    q, keys, pos = _step_case(P_ * 7 + Q, P_, Q, extra)
    want = ref_ops.lookup_step_layer(jnp.asarray(q), jnp.asarray(keys),
                                     jnp.asarray(pos))
    got = il.lookup_step_layer(_t(q), _t(keys), _t(pos))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w))


def _band_case(seed, N, Q, extra):
    rng = np.random.default_rng(seed)
    nk = np.sort(rng.choice(2**24, N, replace=False)).astype(np.int32)
    x1 = nk.astype(np.float32)
    y1 = np.sort(rng.uniform(0, 2**22, N)).astype(np.float32)
    m = rng.uniform(0, 10, N).astype(np.float32)
    d = rng.uniform(1, 100, N).astype(np.float32)
    q = rng.integers(0, 2**24, Q).astype(np.int32)
    if extra:
        q = np.concatenate([q, [0, nk[0] - 1, nk[0], nk[-1], nk[-1] + 1],
                            rng.choice(nk, 5)]).astype(np.int32)
    return q, nk, x1, y1, m, d


BAND_CASES = [(10, 64, False), (300, 300, False), (4096, 512, False),
              (10, 1, False), (300, 257, True), (4096, 257, True),
              (1, 5, True)]


@pytest.mark.parametrize("N,Q,extra", BAND_CASES)
def test_band_layer_within_the_references_bound(N, Q, extra):
    args = _band_case(N * 11 + Q, N, Q, extra)
    want = ref_ops.lookup_band_layer(*(jnp.asarray(a) for a in args))
    oracle = ref_ref.band_lookup_ref(*(jnp.asarray(a) for a in args))
    got = il.lookup_band_layer(*(_t(a) for a in args))
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == torch.int32
        assert np.max(np.abs(_np(g) - _np(w))) <= 4
        assert np.max(np.abs(_np(g) - _np(o))) <= 4
    lo, hi = (_np(g) for g in got)
    assert np.all(hi >= lo + 1)


def test_band_layer_over_the_cap_raises_as_the_reference_asserts():
    args = _band_case(1, 4097, 8, False)
    with pytest.raises(AssertionError):
        ref_ops.lookup_band_layer(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="band layers are tuned small"):
        il.lookup_band_layer(*(_t(a) for a in args))


@pytest.mark.parametrize("P_,Q", [(4097, 64), (20_000, 513), (50_000, 1)])
def test_segmented_plain_version_matches_the_gathered_reference(P_, Q):
    """The port's segmented lookup takes each query's segment start and
    reads the layer in place; the reference gathers (Q, 128) rows first.
    Same function: held on the gathered form of the same segments."""
    q, keys, pos = _step_case(P_ + Q, P_, Q, True)
    S = il.LANE
    g = np.maximum(np.searchsorted(keys[::S], q, side="right") - 1, 0)
    base = (g * S).astype(np.int32)
    idx = np.minimum(base[:, None] + np.arange(S)[None, :], P_ - 1)
    want = ref_ref.segmented_step_lookup_ref(
        jnp.asarray(q), jnp.asarray(keys[idx]), jnp.asarray(pos[:-1][idx]),
        jnp.asarray(pos[1:][idx]))
    got = il.segmented_step_lookup_torch(_t(q), _t(base), _t(keys),
                                         _t(pos[:-1]), _t(pos[1:]))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(_np(g_), _np(w))
    # the last segment repeats entry P − 1, as the reference's clip does
    top = np.full(3, keys[-1], dtype=np.int32)
    tb = np.full(3, (P_ - 1) // S * S, dtype=np.int32)
    lo, hi = il.segmented_step_lookup_torch(_t(top), _t(tb), _t(keys),
                                            _t(pos[:-1]), _t(pos[1:]))
    assert np.all(_np(lo) == pos[-2]) and np.all(_np(hi) == pos[-1])


def test_cpu_tensors_never_reach_a_kernel():
    q, keys, pos = _step_case(3, 20_000, 100, True)
    before = [lib.launches() for lib in K.LIBS]
    il.lookup_step_layer(_t(q), _t(keys), _t(pos))
    il.lookup_step_layer(_t(q), _t(keys[:4096]), _t(pos[:4097]))
    il.lookup_band_layer(*(_t(a) for a in _band_case(4, 300, 50, False)))
    assert [lib.launches() for lib in K.LIBS] == before
    for fn, args in ((K.step_lookup_cuda, (q, keys, pos[:-1], pos[1:])),
                     (K.band_lookup_cuda, _band_case(4, 30, 5, False)),
                     (K.segmented_step_lookup_cuda,
                      (q, keys, pos[:-1], pos[1:]))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*(_t(a) for a in args))
    with pytest.raises(ValueError):
        il.lookup_step_layer(_t(q).to("meta"), _t(keys[:64]), _t(pos[:65]))
    assert [lib.launches() for lib in K.LIBS] == before


# ---------------------------------------------------------------------------
# designs: planes, traverse_index, lookup_batch
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tuned():
    """The tuned int32-domain design of test_kernels.py:52-70, built by
    both packages (their tuners are bit-identical)."""
    rng = np.random.default_rng(5)
    c = rng.uniform(2**20, 2**30, 32)
    keys = np.unique(np.abs(np.concatenate(
        [rng.normal(ci, 2**16, 2000) for ci in c])).astype(np.uint64) + 1)
    grid = dict(lam_low=2**10, lam_high=2**16, base=4.0)
    rres = R.airtune(R.KeyPositions.fixed_record(keys, 16),
                     R.PROFILES["azure_ssd"], R.make_builders(**grid), k=3)
    pres = P.airtune(P.KeyPositions.fixed_record(keys, 16),
                     P.PROFILES["azure_ssd"], P.make_builders(**grid), k=3,
                     score_backend="numpy")
    return keys, rres.design, pres.design


def _manual(mod, keys, mix):
    D = mod.KeyPositions.fixed_record(keys, 16)
    layers, cur = [], D
    for kind, lam in mix:
        lay = (mod.build_gstep(cur, 8, lam) if kind == "gstep"
               else mod.build_gband(cur, lam))
        layers.append(lay)
        cur = mod.outline(lay, cur)
    return mod.IndexDesign(layers=tuple(layers), data=D)


MANUAL = {"step-band-step": (("gstep", 2**7), ("gband", 2**9),
                             ("gstep", 2**7)),
          "band-step": (("gband", 2**8), ("gstep", 2**10)),
          "wide-step": (("gstep", 2**5),)}


def _designs(tuned):
    keys, rdesign, pdesign = tuned
    out = {"tuned": (rdesign, pdesign)}
    for name, mix in MANUAL.items():
        out[name] = (_manual(R, keys, mix), _manual(P, keys, mix))
    return keys, out


def test_device_arrays_from_design_equal_planes(tuned):
    _, designs = _designs(tuned)
    for name, (rd, pd) in designs.items():
        want = ref_ops.device_arrays_from_design(rd)
        got = il.device_arrays_from_design(pd, device="cpu")
        assert [w["kind"] for w in want] == [g["kind"] for g in got], name
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                if k == "kind":
                    continue
                assert g[k].device.type == "cpu"
                assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype), k
                np.testing.assert_array_equal(_np(g[k]), _np(w[k]))


def test_device_arrays_from_design_raises_where_the_reference_asserts():
    keys = np.arange(1, 3001, dtype=np.uint64) * 1_000_003 + 2**31
    for mix in (MANUAL["band-step"], (("gstep", 2**7),)):
        rd, pd = _manual(R, keys, mix), _manual(P, keys, mix)
        with pytest.raises(AssertionError):
            ref_ops.device_arrays_from_design(rd)
        with pytest.raises(ValueError, match="overflow int32"):
            il.device_arrays_from_design(pd, device="cpu")


def test_device_arrays_from_design_defaults_to_the_card(tuned, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        il.device_arrays_from_design(tuned[2])


def test_traverse_index_contains_true_ranges_and_matches_reference(tuned):
    keys, designs = _designs(tuned)
    D = P.KeyPositions.fixed_record(keys, 16)
    qs = np.random.default_rng(42).choice(keys, 512).astype(np.int64)
    qs = np.concatenate([qs, [keys[0], keys[-1]]])
    i = np.searchsorted(D.keys, qs.astype(np.uint64))
    for name, (rd, pd) in designs.items():
        lo, hi = il.traverse_index(il.device_arrays_from_design(
            pd, device="cpu"), _t(qs.astype(np.int32)))
        lo, hi = _np(lo), _np(hi)
        assert np.all(lo <= D.lo[i]) and np.all(hi >= D.hi[i]), name
        rlo, rhi = ref_ops.traverse_index(
            ref_ops.device_arrays_from_design(rd), jnp.asarray(qs, jnp.int32))
        if pd.layers[0].kind == "step":
            np.testing.assert_array_equal(lo, _np(rlo))
            np.testing.assert_array_equal(hi, _np(rhi))
            mem = P.lookup_batch(pd, qs.astype(np.uint64))
            np.testing.assert_array_equal(lo, mem.lo)
            np.testing.assert_array_equal(hi, mem.hi)
        else:
            assert np.max(np.abs(lo - _np(rlo))) <= 4
            assert np.max(np.abs(hi - _np(rhi))) <= 4


@pytest.mark.parametrize("kind", ["gmm", "books"])
@pytest.mark.parametrize("tier", [None, "azure_ssd", "azure_hdd"])
def test_lookup_batch_and_verify_lookup_bit_identical(kind, tier):
    keys = make_keys(kind, 8_000, seed=6)
    qs = np.random.default_rng(2).choice(keys, 600)
    for mix in MANUAL.values():
        rd, pd = _manual(R, keys, mix), _manual(P, keys, mix)
        want = ref_lookup_batch(rd, qs, R.PROFILES[tier] if tier else None)
        got = P.lookup_batch(pd, qs, P.PROFILES[tier] if tier else None)
        for f in ("lo", "hi", "modeled_seconds", "bytes_read"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert P.verify_lookup(pd, qs) is ref_verify_lookup(rd, qs) is True
    empty = P.IndexDesign(layers=(), data=P.KeyPositions.fixed_record(keys, 16))
    ref_empty = R.IndexDesign(layers=(),
                              data=R.KeyPositions.fixed_record(keys, 16))
    got = P.lookup_batch(empty, qs, P.PROFILES["azure_ssd"])
    want = ref_lookup_batch(ref_empty, qs, R.PROFILES["azure_ssd"])
    for f in ("lo", "hi", "modeled_seconds", "bytes_read"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_last_mile_search_identical():
    from repro.core.lookup import last_mile_search as ref_last_mile
    keys = np.sort(np.random.default_rng(1).choice(10**6, 300,
                                                   replace=False)).astype(
        np.uint64)
    for q in (0, int(keys[0]), int(keys[5]) + 1, int(keys[-1]), 10**7):
        assert P.last_mile_search(keys, q) == ref_last_mile(keys, q)
