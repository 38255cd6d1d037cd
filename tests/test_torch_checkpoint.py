"""The port's checkpoints and fault tolerance against the JAX package's:
the same tree (float32 and bfloat16 leaves, a leaf of several 4 MiB
slices, a scalar) written by both gives byte-identical blob, ``.air`` and
``.json`` files; a checkpoint either package wrote restores in the other
with every leaf bit-equal; partial restores read the same bytes; a
corrupted slice raises; and the supervisor logs the same events under the
same injected failure (straggler events, which follow wall time, left
out)."""
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.train import checkpoint as jck
from repro.train import fault_tolerance as jft
from repro_torch import configs as tconfigs
from repro_torch.models import api
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        params_tree)
from repro_torch.train import checkpoint as tck
from repro_torch.train import fault_tolerance as tft

FILES = ("blob", "air", "json")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _files(root, step):
    return {ext: _read(os.path.join(root, f"ckpt-{step}.{ext}"))
            for ext in FILES}


def _tree(dtype):
    """A mixed tree: nested dicts out of key order, a 12 MB leaf (three
    slices), a scalar, bfloat16 leaves when asked."""
    rng = np.random.default_rng(3)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return {"z": rng.normal(size=(3 << 20,)).astype(np.float32),
            "b": {"w": rng.normal(size=(257, 3)).astype(dt),
                  "s": np.int32(7),
                  "a": rng.normal(size=(64,)).astype(dt)},
            "a": rng.integers(0, 9, (5, 4)).astype(np.int64)}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
        return t.numpy().tobytes(), list(leaf.shape)
    return np.asarray(leaf).tobytes(), list(np.asarray(leaf).shape)


def _assert_same_leaves(got, want):
    gl = tck._leaf_paths(got)
    wl = tck._leaf_paths(want)
    assert [n for n, _ in gl] == [n for n, _ in wl]
    for (name, g), (_, w) in zip(gl, wl):
        assert _bits(g) == _bits(w), name


@pytest.mark.parametrize("leaves", ["numpy", "tensors"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_are_byte_identical_for_the_same_tree(tmp_path, dtype, leaves):
    tree = _tree(dtype)
    jck.save_checkpoint(str(tmp_path / "jax"), tree, profile="azure_ssd",
                        step=3)
    port_tree = tree if leaves == "numpy" else _as_tensors(tree)
    meta = tck.save_checkpoint(str(tmp_path / "torch"), port_tree,
                               profile="azure_ssd", step=3)
    assert _files(tmp_path / "torch", 3) == _files(tmp_path / "jax", 3)
    assert len(meta["slices"]) == 3 + 4
    assert [lm["name"] for lm in meta["leaves"]] == ["a", "b/a", "b/s",
                                                     "b/w", "z"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_checkpoint_files_equal_the_references(tmp_path, dtype):
    """A SMOKE model's parameters: the JAX package's tree and the port's
    ``params_tree`` of the same model write the same files (the default
    object_store tier)."""
    jc = jconfigs.get_config("qwen3_14b", smoke=True).scaled(dtype=dtype)
    tc = tconfigs.get_config("qwen3_14b", smoke=True).scaled(dtype=dtype)
    jp = jax.tree.map(np.asarray, japi.init_params(jc, jax.random.PRNGKey(2)))
    model = params_from_numpy(tc, jp, device="cpu")
    jck.save_checkpoint(str(tmp_path / "jax"), jp, step=0)
    tck.save_checkpoint(str(tmp_path / "torch"), params_tree(tc, model),
                        step=0)
    assert _files(tmp_path / "torch", 0) == _files(tmp_path / "jax", 0)
    tree, stats = tck.restore_checkpoint(str(tmp_path / "jax"),
                                         api.param_specs(tc), step=0)
    back = params_from_numpy(tc, tree, device="cpu")
    got = params_to_numpy(tc, back, bfloat16=ml_dtypes.bfloat16)
    _assert_same_leaves(got, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_restores_in_the_other_package(tmp_path, dtype, writer):
    tree = _tree(dtype)
    save = jck.save_checkpoint if writer == "jax" else tck.save_checkpoint
    save(str(tmp_path), tree, profile="azure_ssd", step=5)
    like = jax.tree.map(np.zeros_like, tree)
    jout, jstats = jck.restore_checkpoint(str(tmp_path), like, step=5)
    tout, tstats = tck.restore_checkpoint(str(tmp_path), like, step=5)
    assert tstats == jstats
    _assert_same_leaves(tout, tree)
    _assert_same_leaves(jout, tree)
    assert isinstance(tout["b"]["w"], torch.Tensor)
    assert tout["b"]["w"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                    else torch.float32)
    assert tout["b"]["s"].shape == ()


@pytest.mark.parametrize("keep", ["small", "b/w", "big"])
def test_partial_restore_reads_what_the_reference_reads(tmp_path, keep):
    rng = np.random.default_rng(0)
    tree = {"big": rng.normal(size=(3 << 20,)).astype(np.float32),
            "small": rng.normal(size=(64,)).astype(np.float32),
            "b": {"w": rng.normal(size=(300,)).astype(np.float32)}}
    tck.save_checkpoint(str(tmp_path), tree, profile="azure_ssd", step=0)
    like = jax.tree.map(np.zeros_like, tree)
    jout, jstats = jck.restore_checkpoint(str(tmp_path), like, step=0,
                                          leaf_filter=lambda n: n == keep)
    tout, tstats = tck.restore_checkpoint(str(tmp_path), like, step=0,
                                          leaf_filter=lambda n: n == keep)
    assert tstats == jstats
    for name, leaf in tck._leaf_paths(tout):
        if name == keep:
            assert _bits(leaf) == _bits(dict(tck._leaf_paths(tree))[name])
        else:
            assert leaf is None
    if keep != "big":
        assert tstats["bytes_read"] < 2 << 20


@pytest.mark.parametrize("at", [100, (4 << 20) + 7, (12 << 20) - 2])
def test_a_corrupted_slice_raises(tmp_path, at):
    tree = {"w": np.arange(3 << 20, dtype=np.float32),
            "v": np.arange(10, dtype=np.float32)}
    tck.save_checkpoint(str(tmp_path), tree, profile="azure_ssd", step=0)
    with open(os.path.join(str(tmp_path), "ckpt-0.blob"), "r+b") as f:
        f.seek(at)
        f.write(b"\xff\xff")
    like = jax.tree.map(np.zeros_like, tree)
    for restore in (tck.restore_checkpoint, jck.restore_checkpoint):
        with pytest.raises(AssertionError, match="corrupt"):
            restore(str(tmp_path), like, step=0)
    # a host that does not read the corrupted leaf restores
    out, _ = tck.restore_checkpoint(str(tmp_path), like, step=0,
                                    leaf_filter=lambda n: n == "v")
    assert torch.equal(out["v"], torch.arange(10, dtype=torch.float32))


def test_leaf_names_follow_the_jax_flatten_order():
    tree = {"blocks": {"wq": 1, "ln1": 2}, "embed": 3, "B": {"x": {"y": 4}}}
    want = [("/".join(str(getattr(p, "key", p)) for p in path), leaf)
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tck._leaf_paths(tree) == want
    assert tck.SLICE_BYTES == jck.SLICE_BYTES


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def _supervise(ft, root, kill_at, n_steps, every):
    """Drive one package's supervisor with a host killed at ``kill_at``
    → (log without stragglers, steps, final state, hosts left)."""
    saved = {}

    def save_fn(state, step):
        saved[step] = dict(state)
        with open(os.path.join(root, f"ckpt-{step}.json"), "w") as f:
            f.write("{}")

    sup = ft.TrainingSupervisor(root, ["h0", "h1", "h2", "h3"],
                                ft.FTConfig(checkpoint_every=every), save_fn,
                                lambda step: dict(saved[step]))
    killed = []

    def step_fn(st, step):
        if step in kill_at and step not in killed:
            sup.monitor.kill(kill_at[step])
            killed.append(step)
        return {"x": st["x"] + 1, "seen": st["seen"] + [step]}

    state, steps, log = sup.run({"x": 0, "seen": []}, step_fn,
                                n_steps=n_steps)
    return ([e for e in log if e["event"] != "straggler"], steps, state,
            sup.monitor.hosts)


@pytest.mark.parametrize("kill_at,n_steps,every", [
    ({12: "h2"}, 20, 5),
    ({3: "h0", 9: "h3"}, 14, 4),
    ({2: "h1"}, 6, 10),          # a failure before any checkpoint
])
def test_supervisor_events_equal_the_references(tmp_path, kill_at, n_steps,
                                                every):
    got = _supervise(tft, str(tmp_path / "torch"), kill_at, n_steps, every)
    want = _supervise(jft, str(tmp_path / "jax"), kill_at, n_steps, every)
    assert got == want
    assert [e["event"] for e in got[0]].count("failure") == len(kill_at)


def test_ft_config_defaults_equal_the_references():
    assert tft.FTConfig() == tft.FTConfig(50, 60.0, 30.0, 3)
    assert jft.FTConfig() == jft.FTConfig(50, 60.0, 30.0, 3)


def test_supervisor_gives_up_after_its_restarts_as_the_reference(tmp_path):
    for ft in (tft, jft):
        root = str(tmp_path / ft.__name__)
        sup = ft.TrainingSupervisor(root, ["h0", "h1", "h2"],
                                    ft.FTConfig(max_restarts=1),
                                    lambda st, step: None, lambda step: st)

        def step_fn(st, step):
            sup.monitor.kill(f"h{step}")
            return st

        st = {}
        with pytest.raises(RuntimeError, match="too many restarts"):
            sup.run(st, step_fn, n_steps=5)


@pytest.mark.parametrize("n_hosts,chips,mp", [
    (16, 16, 16), (15, 16, 16), (1, 4, 4), (3, 4, 2), (7, 8, 4), (2, 1, 1)])
def test_elastic_mesh_shape_equals_the_references(n_hosts, chips, mp):
    assert tft.elastic_mesh_shape(n_hosts, chips, mp) == \
        jft.elastic_mesh_shape(n_hosts, chips, mp)


@pytest.mark.parametrize("batch,old,new", [(256, 16, 8), (64, 4, 2),
                                           (12, 4, 3), (256, 16, 16)])
def test_rescale_batch_equals_the_references(batch, old, new):
    assert tft.rescale_batch(batch, old, new) == \
        jft.rescale_batch(batch, old, new)


def test_rescale_batch_refuses_an_indivisible_batch_as_the_reference():
    for ft in (tft, jft):
        with pytest.raises(AssertionError, match="not divisible"):
            ft.rescale_batch(10, 4, 3)


def test_heartbeat_monitor_equals_the_references(tmp_path):
    for ft, root in ((tft, tmp_path / "t"), (jft, tmp_path / "j")):
        mon = ft.HeartbeatMonitor(str(root), ["a", "b", "c"], timeout_s=60)
        assert mon.surviving() == ["a", "b", "c"]
        mon.beat("a", 1)
        mon.kill("b")
        assert mon.surviving() == ["a", "c"]
        assert sorted(os.listdir(root / "hb")) == ["a.hb", "b.dead"]
