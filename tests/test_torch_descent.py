"""The port's resident-prefix descent against the JAX package's.

Same inputs to both packages: 60k keys < 2^30 (numpy seed 11), three
family mixes written as one reference index file each, prefixes of depth
0–3 parsed by both engines, ragged query batches (seed 5).

Tolerances: the float64 walk and the packed planes are bit-identical;
the plain PyTorch version's step rows equal the float64 walk exactly and
its band rows contain it; against the JAX package's jnp and Pallas
(interpret) paths it differs by at most 4 (their FMA contraction bound,
as in ``tests/test_fused_descent.py``).
"""
import numpy as np
import pytest
import torch

from repro.api import ServeSpec as RefServeSpec
from repro.core import IndexDesign as RefDesign
from repro.core import KeyPositions as RefKP
from repro.core import write_index as ref_write_index
from repro.core.builders import build_eband as ref_eband
from repro.core.builders import build_gband as ref_gband
from repro.core.builders import build_gstep as ref_gstep
from repro.core.descent import descend_layers as ref_descend_layers
from repro.core.nodes import outline as ref_outline
from repro.kernels import fused_descent as ref_fd
from repro.serve.index_service import IndexService as RefService

from repro_torch.api import ServeSpec
from repro_torch.core.descent import descend_layers
from repro_torch.kernels import fused_descent as fd
from repro_torch.serve import IndexService

MIXES = {
    "gstep3": ("gstep", "gstep", "gstep"),
    "step-band-step": ("gstep", "gband", "gstep"),
    "band-eband-step": ("gband", "eband", "gstep"),
}
_BUILD = {"gstep": lambda D, lam: ref_gstep(D, 8, lam),
          "gband": ref_gband, "eband": ref_eband}
BATCHES = (1, 7, 256, 600)
FMA_BOUND = 4


def _ref_design(D, kinds):
    layers, cur = [], D
    for kind, lam in zip(kinds, (2**10, 2**9, 2**7)):
        lay = _BUILD[kind](cur, lam)
        layers.append(lay)
        cur = ref_outline(lay, cur)
    return RefDesign(layers=tuple(layers), data=D)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """{mix: (reference prefix, port prefix)} parsed from one reference
    file each, plus in-domain queries."""
    rng0 = np.random.default_rng(11)
    keys = np.unique(rng0.integers(1, 2**30, 60_000).astype(np.uint64))
    D = RefKP.fixed_record(keys, 16)
    qs = np.random.default_rng(5).choice(D.keys, 600)
    root = tmp_path_factory.mktemp("torch_fused")
    out = {}
    for name, kinds in MIXES.items():
        path = str(root / f"{name}.air")
        ref_write_index(path, _ref_design(D, kinds), page_bytes=1024)
        with RefService(path, profile=None,
                        spec=RefServeSpec(resident_layers=3)) as r:
            ref_prefix = r._prefix
        with IndexService(path, profile=None, device="cpu",
                          spec=ServeSpec(resident_layers=3,
                                         backend="numpy")) as s:
            port_prefix = s._prefix
        out[name] = (ref_prefix, port_prefix)
    return out, qs


def test_parsed_prefixes_identical(stacks):
    prefixes, _ = stacks
    for name, (ref_prefix, port_prefix) in prefixes.items():
        assert len(ref_prefix) == len(port_prefix) == 3
        for a, b in zip(ref_prefix, port_prefix):
            assert a.keys() == b.keys() and a["kind"] == b["kind"]
            for k in a:
                if k != "kind":
                    np.testing.assert_array_equal(a[k], b[k])
                    assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_descend_layers_bit_identical(stacks, name, depth):
    prefixes, qs = stacks
    ref_prefix, port_prefix = prefixes[name]
    for n in BATCHES:
        want_lo, want_hi = ref_descend_layers(ref_prefix[:depth], qs[:n])
        lo, hi = descend_layers(port_prefix[:depth], qs[:n])
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)
        lo, hi, used = fd.fused_descent_with_backend(
            port_prefix[:depth], qs[:n], backend="numpy")
        assert used == "numpy" and lo.shape == (depth, n)
        np.testing.assert_array_equal(lo, want_lo)
        np.testing.assert_array_equal(hi, want_hi)


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pack_prefix_planes_identical(stacks, name, depth):
    prefixes, _ = stacks
    ref_prefix, port_prefix = prefixes[name]
    want = ref_fd.pack_prefix(ref_prefix[:depth])
    got = fd.pack_prefix(port_prefix[:depth])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", sorted(MIXES))
def test_plain_torch_against_reference_device_paths(stacks, name):
    prefixes, qs = stacks
    ref_prefix, port_prefix = prefixes[name]
    for depth in (1, 2, 3):
        rlo, rhi = ref_descend_layers(ref_prefix[:depth], qs)
        tlo, thi, used = fd.fused_descent_with_backend(
            port_prefix[:depth], qs, backend="cuda", device="cpu")
        assert used == "cuda"
        jlo, jhi, ju = ref_fd.fused_descent_with_backend(
            ref_prefix[:depth], qs, backend="jnp")
        plo, phi, pu = ref_fd.fused_descent_with_backend(
            ref_prefix[:depth], qs, backend="pallas", interpret=True)
        assert ju == "jnp" and pu == "pallas"
        kinds = fd.pack_prefix(port_prefix[:depth])["kinds"]
        for r in range(depth):
            if kinds[r] == 0:                  # step rows: exact
                np.testing.assert_array_equal(tlo[r], rlo[r])
                np.testing.assert_array_equal(thi[r], rhi[r])
            else:                              # band rows: contain the walk
                assert np.all(tlo[r] <= rlo[r]) and np.all(thi[r] >= rhi[r])
        for other_lo, other_hi in ((jlo, jhi), (plo, phi)):
            assert np.max(np.abs(tlo - other_lo)) <= FMA_BOUND
            assert np.max(np.abs(thi - other_hi)) <= FMA_BOUND


def test_plain_torch_ragged_batches_match_full_batch(stacks):
    prefixes, qs = stacks
    layers = prefixes["step-band-step"][1]
    flo, fhi, _ = fd.fused_descent_with_backend(layers, qs, device="cpu")
    off = 0
    for n in (1, 7, 255, 256, 81):
        blo, bhi, _ = fd.fused_descent_with_backend(
            layers, qs[off:off + n], device="cpu")
        np.testing.assert_array_equal(blo, flo[:, off:off + n])
        np.testing.assert_array_equal(bhi, fhi[:, off:off + n])
        off += n


def test_fused_descent_module_on_cpu_equals_plain_version(stacks):
    prefixes, qs = stacks
    planes = fd.pack_prefix(prefixes["band-eband-step"][1])
    mod = fd.FusedDescent(planes, device="cpu")
    assert all(b.device.type == "cpu" for b in mod.buffers())
    assert {n for n, _ in mod.named_buffers()} == set(planes)
    qt = torch.from_numpy(qs.astype(np.int32))
    lo, hi = mod(qt)
    plo, phi = fd.fused_descent_torch(
        {k: torch.from_numpy(v) for k, v in planes.items()}, qt)
    assert lo.dtype == torch.int32 and lo.shape == (3, len(qs))
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


def _step(keys, pos_hi_max=None):
    n = len(keys)
    pos = np.arange(n + 1, dtype=np.int64) * 8
    if pos_hi_max is not None:
        pos[-1] = pos_hi_max
    return {"kind": "step", "keys": np.asarray(keys, dtype=np.uint64),
            "pos_lo": pos[:-1], "pos_hi": pos[1:]}


def _band(x1):
    n = len(x1)
    return {"kind": "band", "x1": np.asarray(x1, dtype=np.uint64),
            "y1": np.arange(n, dtype=np.float64) * 40,
            "m": np.full(n, 1e-3), "delta": np.full(n, 2.0)}


GUARD_CASES = {
    "empty": [],
    "step_key_over_int32": [_step([0, 2**31 - 1])],
    "step_pos_over_int32": [_step([0, 5], pos_hi_max=2**31 - 1)],
    "band_x1_over_int32": [_band([0, 2**31 - 1])],
    "too_wide": [_step(np.arange(fd.MAX_VMEM_ENTRIES + 1))],
    "in_range": [_step([0, 5, 9]), _band([0, 3, 2**31 - 2])],
    "at_width_cap": [_step(np.arange(fd.MAX_VMEM_ENTRIES))],
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guards_decline_exactly_where_the_reference_does(case):
    layers = GUARD_CASES[case]
    want = ref_fd.pack_prefix(layers)
    got = fd.pack_prefix(layers)
    assert (got is None) == (want is None)
    q_ok = np.asarray([1, 4, 7], dtype=np.uint64)
    q_big = np.asarray([1, 2**31 - 1], dtype=np.uint64)
    for q in (q_ok, q_big):
        _, _, ref_used = ref_fd.fused_descent_with_backend(layers, q,
                                                           backend="jnp")
        lo, hi, used = fd.fused_descent_with_backend(layers, q,
                                                     device="cpu")
        assert (used == "numpy") == (ref_used == "numpy")
        assert lo.shape == (len(layers), len(q))


def test_numpy_backend_never_touches_a_device():
    layers = GUARD_CASES["in_range"]
    q = np.asarray([1, 4, 7], dtype=np.uint64)
    lo, hi, used = fd.fused_descent_with_backend(layers, q, backend="numpy")
    want_lo, want_hi = ref_descend_layers(layers, q)
    assert used == "numpy"
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)
    with pytest.raises(ValueError):
        fd.fused_descent_with_backend(layers, q, backend="pallas")


def test_plane_geometry_is_decided_once_and_equals_the_reference():
    from repro_torch.kernels.fused_descent import kernel as K
    assert (fd.ops.MAX_VMEM_ENTRIES, fd.ops.LANE) == (
        ref_fd.ops.MAX_VMEM_ENTRIES, ref_fd.ops.LANE)
    assert (K.MAX_P, K.LANE) == (fd.ops.MAX_VMEM_ENTRIES, fd.ops.LANE)
    # nvcc sizes the kernel's shared-memory plane from this flag alone
    assert f"-DMAX_P={fd.ops.MAX_VMEM_ENTRIES}" in K.LIB.flags
    assert "#define MAX_P" not in K.LIB.source.read_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_band_slack_identical(seed):
    rng = np.random.default_rng(seed)
    y1, m, x1 = (rng.uniform(0, 2**30, 50), rng.uniform(-4, 4, 50),
                 rng.integers(0, 2**31, 50).astype(np.uint64))
    np.testing.assert_array_equal(fd.band_f32_slack(y1, m, x1),
                                  ref_fd.band_f32_slack(y1, m, x1))
