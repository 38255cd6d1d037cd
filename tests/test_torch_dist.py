"""The multi-device slice of the port against the JAX package: the sharding
rules (``repro_torch.dist``), the meshes (``repro_torch.launch.mesh``),
the int8 compressed all-reduce (``repro_torch.train.compression``) and
the sequence-sharded flash-decode (``repro_torch.serve.attention``).

The rules run from a mesh's shape and axis names alone on both sides (a
``MeshShape`` here, a ``jax.sharding.AbstractMesh`` there), so every rule
is held at the (2, 4) test mesh and at the production (16, 16) and
(2, 16, 16) meshes for all ten configs.  The collectives run once per
module on 4 ``gloo`` ranks (spawned from one subprocess, a ``file://``
rendezvous) and once on the JAX side in a subprocess with 8 forced host
devices (``shard_map`` over 4 of them for the compression, the (2, 4)
mesh of ``tests/test_flash_decode_sharded.py`` for the decode); the tests
are cases over those results.  Compression is bit-equal; the decode is
held at 3e-5 in float32, the JAX package's own bound for it.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.dist import sharding as JS
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as TS
from repro_torch.launch import mesh as TM
from repro_torch.models import api as tapi
from repro_torch.train import compression as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the inputs both sides draw, run here and at the head of each script
HELPERS = r"""
import numpy as np

RANKS = 4
LENGTHS = (256, 256 - 17, 64, 1)        # tests/test_flash_decode_sharded.py
B, HQ, HKV, S, HD = 2, 8, 2, 256, 64
LEAVES = {"w": (64, 33), "b": (17,), "blk/x": (5, 7)}
STEPS = 3
EF_STEPS = 30                           # tests/test_substrates.py


def rank_grads(rank, step):
    # rank ``rank``'s float32 gradient leaves at ``step``
    rng = np.random.default_rng(1000 * step + rank)
    return {k: (rng.normal(size=s) * (1 + rank)).astype(np.float32)
            for k, s in LEAVES.items()}


def decode_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, HQ, HD)).astype(np.float32),
            rng.normal(size=(B, HKV, S, HD)).astype(np.float32),
            rng.normal(size=(B, HKV, S, HD)).astype(np.float32))
"""
exec(HELPERS)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the sharding rules, from shapes alone
# ---------------------------------------------------------------------------
def _specs(tree, form, is_jax):
    """The tree with each sharding's spec in ``form`` (str or tuple)."""
    if is_jax:
        return jax.tree.map(lambda s: form(s.spec), tree)
    return TS.tree_map(lambda s: form(s.spec), tree)


def _check_placements(tree, axis_names):
    from torch.distributed.tensor import Replicate, Shard

    def one(s):
        assert len(s.placements) == len(axis_names)
        for axis, pl in zip(axis_names, s.placements):
            dims = [d for d, e in enumerate(s.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            assert pl == (Shard(dims[0]) if dims else Replicate()), \
                (s.spec, axis, pl)
    TS.tree_map(one, tree)


def _both(mesh_name):
    sizes, axes = MESHES[mesh_name]
    return AbstractMesh(sizes, axes), TM.MeshShape(sizes, axes)


def _same(jtree, ttree, axes):
    for form in (str, tuple):
        assert _specs(ttree, form, False) == _specs(jtree, form, True)
    _check_placements(ttree, axes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_sharding_rules_equal_the_jax_packages(arch, mesh_name):
    jmesh, tmesh = _both(mesh_name)
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    axes = tmesh.axis_names
    jp, tp = japi.param_specs(jc), tapi.param_specs(tc)
    # zero=True is the ZeRO-1 moments' rule (moments have the params'
    # shapes)
    for zero in (False, True):
        _same(JS.param_shardings(jc, jp, jmesh, zero=zero),
              TS.param_shardings(tc, tp, tmesh, zero=zero), axes)
    n_shapes = 0
    for name, shape in japi.SHAPES.items():
        if not japi.shape_supported(jc, shape):
            assert not tapi.shape_supported(tc, tapi.SHAPES[name])
            continue
        n_shapes += 1
        tshape = tapi.SHAPES[name]
        _same(JS.batch_sharding(jmesh, japi.input_specs(jc, shape)),
              TS.batch_sharding(tmesh, tapi.input_specs(tc, tshape)), axes)
        _same(JS.decode_state_shardings(
                  jc, japi.decode_state_specs(jc, shape.global_batch,
                                              shape.seq_len), jmesh),
              TS.decode_state_shardings(
                  tc, tapi.decode_state_specs(tc, tshape.global_batch,
                                              tshape.seq_len), tmesh),
              axes)
    assert n_shapes > 0
    _same(JS.replicated(jmesh), TS.replicated(tmesh), axes)


class _Spec:
    def __init__(self, shape):
        self.shape = tuple(shape)


def test_the_2x4_cases_of_the_jax_packages_sharding_test():
    """The leaves of ``tests/test_dist_sharding.py`` and the specs it
    asserts, through the port's rules at the same (2, 4) mesh."""
    mesh = TM.MeshShape((2, 4), ("data", "model"))
    params = {"emb": _Spec((128, 64)), "blocks": _Spec((6, 128, 64)),
              "scalar": _Spec(()), "odd": _Spec((7, 9))}
    got = {k: str(s.spec) for k, s in
           TS.param_shardings(None, params, mesh).items()}
    assert got == {"emb": "PartitionSpec(None, 'model')",
                   "blocks": "PartitionSpec(None, None, 'model')",
                   "scalar": "PartitionSpec()",
                   "odd": "PartitionSpec(None, None)"}
    zs = TS.param_shardings(None, params, mesh, zero=True)
    assert str(zs["emb"].spec) == "PartitionSpec('data', 'model')"
    assert str(zs["blocks"].spec) == "PartitionSpec('data', None, 'model')"
    bs = TS.batch_sharding(mesh, {"x": _Spec((4, 16)), "odd": _Spec((3, 16)),
                                  "empty": _Spec(())})
    assert {k: str(s.spec) for k, s in bs.items()} == {
        "x": "PartitionSpec('data', None)",
        "odd": "PartitionSpec(None, None)", "empty": "PartitionSpec()"}
    ds = TS.decode_state_shardings(None, {"kv": _Spec((6, 4, 8, 64)),
                                          "odd_b": _Spec((6, 3, 8, 64)),
                                          "vec": _Spec((6,))}, mesh)
    assert str(ds["kv"].spec) == "PartitionSpec(None, 'data', 'model', None)"
    assert str(ds["odd_b"].spec) == \
        "PartitionSpec(None, None, 'model', None)"
    assert str(ds["vec"].spec) == "PartitionSpec(None,)"
    assert str(TS.replicated(mesh).spec) == "PartitionSpec()"


def test_constrain_residual_is_the_identity_without_a_mesh():
    x = torch.zeros(4, 16)
    TS.set_activation_mesh(None)
    assert TS.constrain_residual(x) is x
    TS.set_activation_mesh(TM.MeshShape((1, 1), ("data", "model")))
    try:
        assert TS.constrain_residual(x) is x           # a trivial mesh
    finally:
        TS.set_activation_mesh(None)


def test_production_meshes_have_the_jax_packages_shapes():
    for multi_pod in (False, True):
        jm = AbstractMesh(*((2, 16, 16), ("pod", "data", "model"))
                          if multi_pod else ((16, 16), ("data", "model")))
        tm = TM.production_shape(multi_pod=multi_pod)
        assert tm.shape == dict(jm.shape)
        assert tm.axis_names == jm.axis_names and tm.size == jm.size
    with pytest.raises(RuntimeError, match="256 ranks"):
        TM.make_production_mesh()


# ---------------------------------------------------------------------------
# compression on one process (no group needed)
# ---------------------------------------------------------------------------
def test_compress_decompress_equals_the_jax_packages():
    from repro.train.compression import compress_decompress
    for seed, scale in ((0, 1.0), (1, 1e-3), (2, 300.0)):
        x = (np.random.default_rng(seed).normal(size=(1000,)) * scale) \
            .astype(np.float32)
        want = np.asarray(compress_decompress(jax.numpy.asarray(x)))
        got = TC.compress_decompress(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        # the int8 error bound of tests/test_substrates.py
        assert np.abs(x - got).max() <= np.abs(x).max() / 127.0 + 1e-6 * \
            scale
    zero = torch.zeros(8)
    assert torch.equal(TC.compress_decompress(zero), zero)


def test_the_residual_is_one_rounding_in_chunks(monkeypatch):
    """``g − q·step`` rounded once (XLA's fused multiply-add), the same
    whatever the chunk; the error state starts at zeros of each leaf."""
    from repro_torch.models.prng import fma
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(37, 11)).astype(np.float32))
    scale = g.abs().max()
    qf = TC.quantize_int8(g, scale).to(torch.float32)
    step = scale * TC.INV_127
    whole = fma(-qf, step.expand_as(qf), g)
    monkeypatch.setattr(TC, "RESIDUAL_CHUNK", 7)
    assert torch.equal(TC._residual(g, qf, step), whole)
    # the residual is the int8 error: at most half a step
    assert float(whole.abs().max()) <= float(step) / 2 * (1 + 1e-6)
    err = TC.init_error_state({"a": g, "b": [_Spec((3,))]}, device="cpu")
    assert torch.equal(err["a"], torch.zeros_like(g))
    assert err["b"][0].shape == (3,) and err["b"][0].dtype == torch.float32
    assert err["b"][0].device.type == "cpu"


def test_error_state_of_specs_goes_to_the_card_unless_named(monkeypatch):
    """A spec leaf has no device: its buffer goes where the caller names,
    else to the card, and with no card it raises rather than fall back to
    the CPU.  A tensor leaf keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.init_error_state({"w": _Spec((2, 3))})
    tensors = TC.init_error_state({"w": torch.ones(2, 3)})
    assert torch.equal(tensors["w"], torch.zeros(2, 3))


def test_combine_stacked_is_the_kernels_plain_combine():
    """Shard lengths clip the global lengths to each shard, and the
    combine of partials stacked on one device is the kernel package's
    plain combine (``combine_partials``, what ``chip_smoke.py`` phase 16
    runs; the ranks run the same code through all-reduces), equal to
    decode over the whole cache."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serve import attention as SA
    q, k, v = (torch.from_numpy(a) for a in decode_inputs())
    Sl = S // RANKS
    lengths = torch.tensor([S - 17, 70], dtype=torch.int32)
    assert SA.shard_lengths(lengths, 1, Sl).tolist() == [Sl, 6]
    assert SA.shard_lengths(lengths, 3, Sl).tolist() == [Sl - 17, 0]
    parts = [da.decode_attention(q, k[:, :, i * Sl:(i + 1) * Sl],
                                 v[:, :, i * Sl:(i + 1) * Sl],
                                 SA.shard_lengths(lengths, i, Sl))
             for i in range(RANKS)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    whole = da.decode_attention(q, k, v, lengths)[0]
    got = da.combine_partials(o, m, l)[0]
    assert float((got - whole).abs().max()) < 3e-5


# ---------------------------------------------------------------------------
# the collectives: 4 gloo ranks, and the JAX package on forced host devices
# ---------------------------------------------------------------------------
RANKS_SCRIPT = HELPERS + r"""
import os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

out_dir = sys.argv[1]


def worker(rank):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + out_dir
                            + "/rendezvous", rank=rank, world_size=RANKS)
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.dist import sharding as TS
    from repro_torch.launch import mesh as TM
    from repro_torch.serve.attention import flash_decode_sharded
    from repro_torch.train import compression as TC
    res = {}
    # compressed_psum with error feedback over STEPS steps
    grads = [{k: torch.from_numpy(v) for k, v in rank_grads(rank, s).items()}
             for s in range(STEPS)]
    err = TC.init_error_state(grads[0])
    for s in range(STEPS):
        mean, err = TC.compressed_psum(grads[s], err)
        for k in mean:
            res[f"mean/{s}/{k}"] = mean[k].numpy()
            res[f"err/{s}/{k}"] = err[k].numpy()
    # error feedback: one gradient a rank, EF_STEPS steps
    g = {"g": torch.from_numpy(rank_grads(rank, 0)["w"])}
    err = TC.init_error_state(g)
    acc = torch.zeros_like(g["g"])
    for _ in range(EF_STEPS):
        mean, err = TC.compressed_psum(g, err)
        acc += mean["g"]
    res["ef_mean"] = (acc / EF_STEPS).numpy()
    # flash-decode over this rank's contiguous shard, by group and by mesh
    q, k, v = decode_inputs()
    S_local = k.shape[2] // RANKS
    part = slice(rank * S_local, (rank + 1) * S_local)
    ck = torch.from_numpy(np.ascontiguousarray(k[:, :, part]))
    cv = torch.from_numpy(np.ascontiguousarray(v[:, :, part]))
    by_group = flash_decode_sharded(None)
    by_mesh = flash_decode_sharded(TM.make_mesh((1, RANKS),
                                                ("data", "model")), "model")
    for L in LENGTHS:
        lengths = torch.full((q.shape[0],), L, dtype=torch.int32)
        res[f"decode/group/{L}"] = by_group(torch.from_numpy(q), ck, cv,
                                            lengths).numpy()
        res[f"decode/mesh/{L}"] = by_mesh(torch.from_numpy(q), ck, cv,
                                          lengths).numpy()
    # meshes, placements and the residual constraint on a (2, 2) mesh
    mesh = TM.make_mesh((2, 2), ("data", "model"))
    try:
        TM.make_production_mesh()
    except ValueError as e:
        res["production_error"] = np.array(str(e))
    emb = torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64)
    sh = TS.param_shardings(None, {"emb": emb}, mesh, zero=True)["emb"]
    d = distribute_tensor(emb, mesh, sh.placements)
    res["emb_local"] = d.to_local().numpy()
    res["emb_full"] = d.full_tensor().numpy()
    TS.set_activation_mesh(mesh)
    x = distribute_tensor(torch.arange(64, dtype=torch.float32)
                          .reshape(4, 16), mesh, [Replicate(), Replicate()])
    y = TS.constrain_residual(x)
    res["residual_placements"] = np.array(str(tuple(y.placements)))
    res["residual_local"] = y.to_local().numpy()
    odd = distribute_tensor(torch.zeros(3, 16), mesh,
                            [Replicate(), Replicate()])
    res["residual_odd_identity"] = np.array(TS.constrain_residual(odd)
                                            is odd)
    plain = torch.zeros(4, 16)
    res["residual_plain_identity"] = np.array(TS.constrain_residual(plain)
                                              is plain)
    TS.set_activation_mesh(None)
    res["residual_cleared_identity"] = np.array(TS.constrain_residual(x)
                                                is x)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(worker, nprocs=RANKS, start_method="spawn")
    print("RANKS OK")
"""

JAX_SCRIPT = HELPERS + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

out_dir = sys.argv[1]
from repro.serve.attention import flash_decode_sharded
from repro.train.compression import compressed_psum

res = {}
pods = Mesh(np.array(jax.devices()[:RANKS]), ("pod",))


def local(g, e):
    mean, err = compressed_psum({k: v[0] for k, v in g.items()},
                                {k: v[0] for k, v in e.items()}, "pod")
    return ({k: v[None] for k, v in mean.items()},
            {k: v[None] for k, v in err.items()})


step = jax.jit(jax.shard_map(local, mesh=pods, in_specs=P("pod"),
                             out_specs=P("pod"), check_vma=False))
keys = rank_grads(0, 0).keys()
err = {k: jnp.zeros((RANKS, *rank_grads(0, 0)[k].shape), jnp.float32)
       for k in keys}
for s in range(STEPS):
    g = {k: jnp.asarray(np.stack([rank_grads(r, s)[k]
                                  for r in range(RANKS)])) for k in keys}
    mean, err = step(g, err)
    for k in keys:
        res[f"mean/{s}/{k}"] = np.asarray(mean[k])
        res[f"err/{s}/{k}"] = np.asarray(err[k])

mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
q, k, v = (jnp.asarray(a) for a in decode_inputs())
with mesh:
    fd = jax.jit(flash_decode_sharded(mesh, "model"))
    for L in LENGTHS:
        res[f"decode/{L}"] = np.asarray(fd(q, k, v, jnp.full((q.shape[0],), L,
                                                             jnp.int32)))
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX OK")
"""


def _run(script, out_dir, env):
    # a file, not ``-c``: spawned ranks import the worker from it
    path = os.path.join(out_dir, "ranks.py")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(script)
    out = subprocess.run([sys.executable, path, out_dir],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' collectives, run once for the module, side by side."""
    out_dir = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    try:
        _run(RANKS_SCRIPT, out_dir, env)
    finally:
        _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(RANKS)]
    return ranks, dict(np.load(os.path.join(out_dir, "jax.npz")))


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_compressed_psum_is_bit_equal_to_the_jax_packages(runs, step, leaf):
    ranks, want = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(_bits(got[f"mean/{step}/{leaf}"]),
                                      _bits(want[f"mean/{step}/{leaf}"][r]))
        np.testing.assert_array_equal(_bits(got[f"err/{step}/{leaf}"]),
                                      _bits(want[f"err/{step}/{leaf}"][r]))


@pytest.mark.parametrize("how", ["group", "mesh"])
@pytest.mark.parametrize("length", LENGTHS)
def test_flash_decode_sharded_matches_the_jax_packages(runs, length, how):
    ranks, want = runs
    from repro.kernels.decode_attention import ref
    q, k, v = decode_inputs()
    full, _, _ = ref.decode_attention_ref(q, k, v, np.full((B,), length,
                                                           np.int32))
    for got in ranks:
        out = got[f"decode/{how}/{length}"]
        assert out.shape == (B, HQ, HD) and out.dtype == np.float32
        assert np.abs(out - want[f"decode/{length}"]).max() < 3e-5
        assert np.abs(out - np.asarray(full)).max() < 3e-5


def test_meshes_placements_and_the_residual_on_gloo_ranks(runs):
    ranks, _ = runs
    emb = np.arange(128 * 64, dtype=np.float32).reshape(128, 64)
    for r, got in enumerate(ranks):
        assert "needs 256 ranks; the world has 4" in \
            str(got["production_error"])
        # zero=True on (2, 2): rows over "data", columns over "model"
        data, model = divmod(r, 2)
        np.testing.assert_array_equal(
            got["emb_local"], emb[data * 64:(data + 1) * 64,
                                  model * 32:(model + 1) * 32])
        np.testing.assert_array_equal(got["emb_full"], emb)
        assert str(got["residual_placements"]) == \
            "(Shard(dim=0), Replicate())"
        np.testing.assert_array_equal(
            got["residual_local"],
            np.arange(64, dtype=np.float32).reshape(4, 16)[
                data * 2:(data + 1) * 2])
        for key in ("residual_odd_identity", "residual_plain_identity",
                    "residual_cleared_identity"):
            assert bool(got[key]), key


def test_error_feedback_converges_on_gloo_ranks(runs):
    """Error feedback over EF_STEPS steps of one gradient a rank: the
    mean of the compressed reductions converges to the ranks' true mean
    (relative error under 0.02, tests/test_substrates.py's bound)."""
    ranks, _ = runs
    true = np.mean([rank_grads(r, 0)["w"] for r in range(RANKS)], axis=0)
    for got in ranks:
        rel = np.linalg.norm(got["ef_mean"] - true) / np.linalg.norm(true)
        assert rel < 0.02, rel
