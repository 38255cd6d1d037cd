"""The port stands alone: no import of ``jax`` or ``repro`` anywhere in
``src/repro_torch`` or ``chip_smoke.py``; every module imports on its own,
first, with jax blocked; entry points run on the card unless the caller
names the CPU, and the kernel paths have no fallback (a CPU tensor never
reaches a kernel, a failed build raises, a missing card raises)."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (PROFILES, KeyPositions, TuneStats, airtune,
                              beam_search, brute_force, make_builders,
                              write_index)
from repro_torch.core.sweep import SweepEngine
from repro_torch.kernels import _cuda
from repro_torch.kernels import fused_descent as fd
from repro_torch.kernels.candidate_score import kernel as CK
from repro_torch.kernels.fused_descent import kernel as K
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.index_lookup import kernel as IK
from repro_torch.serve import IndexService, demo_serving_design

LIBS = [K.LIB, CK.LIB, *IK.LIBS, DK.LIB, AK.LIB]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert bad == [], f"{path} imports {bad}"


def test_every_port_module_imports_with_jax_blocked():
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in ("repro_torch.serve.index_service", "repro_torch.core.sweep",
                 "repro_torch.core.airtune", "repro_torch.core.baselines",
                 "repro_torch.kernels.candidate_score.kernel",
                 "repro_torch.kernels._cuda", "repro_torch.api.spec",
                 "repro_torch.api.index", "repro_torch.api.drift",
                 "repro_torch.core.lookup",
                 "repro_torch.kernels.index_lookup.kernel",
                 "repro_torch.kernels.index_lookup.ops",
                 "repro_torch.kernels.decode_attention.kernel",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.models.transformer", "repro_torch.models.api",
                 "repro_torch.models.params", "repro_torch.models.layers",
                 "repro_torch.models.linear_scan", "repro_torch.models.ssm",
                 "repro_torch.models.rwkv", "repro_torch.models.whisper",
                 "repro_torch.configs.zamba2_1p2b",
                 "repro_torch.models.convert", "repro_torch.configs.qwen3_14b",
                 "repro_torch.serve.serve_step", "repro_torch.serve.kvcache",
                 "repro_torch.launch.serve", "repro_torch.fleet",
                 "repro_torch.fleet.fleet", "repro_torch.fleet.service",
                 "repro_torch.data", "repro_torch.data.datasets",
                 "repro_torch.data.store", "repro_torch.train",
                 "repro_torch.train.optimizer",
                 "repro_torch.train.train_step",
                 "repro_torch.train.checkpoint",
                 "repro_torch.train.fault_tolerance",
                 "repro_torch.launch.train", "repro_torch.models.prng",
                 "repro_torch.analysis", "repro_torch.analysis.core",
                 "repro_torch.analysis.__main__",
                 "repro_torch.analysis.rules",
                 "repro_torch.analysis.rules.kernel_fallback",
                 "repro_torch.analysis.rules.lock_discipline",
                 "repro_torch.analysis.rules.pread_seam",
                 "repro_torch.analysis.rules.shim_discipline",
                 "repro_torch.analysis.rules.spec_roundtrip",
                 "repro_torch.analysis.rules.typed_error_flow",
                 "repro_torch.dist", "repro_torch.dist.sharding",
                 "repro_torch.launch.mesh", "repro_torch.train.compression",
                 "repro_torch.serve.attention",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.trace_analysis",
                 "repro_torch.kernels._meta"):
        assert name in names
    # each module is imported first, into a process that holds no other
    # module of the port, so an import cycle cannot hide behind the order
    code = ("import sys, importlib\n"
            "for blocked in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {names!r}:\n"
            "    for mod in [m for m in sys.modules\n"
            "                if m.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[mod]\n"
            "    importlib.import_module(name)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    keys = np.unique(np.random.default_rng(1).integers(
        1, 2**30, 20_000).astype(np.uint64))
    path = str(tmp_path_factory.mktemp("iso") / "idx.air")
    write_index(path, demo_serving_design(KeyPositions.fixed_record(keys, 16)),
                page_bytes=4096)
    return path, keys


def test_entry_points_need_a_card_unless_told_otherwise(small_index,
                                                        monkeypatch):
    path, keys = small_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndexService(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fd.FusedDescent(fd.pack_prefix(
            [{"kind": "step", "keys": keys[:4], "pos_lo": np.arange(4),
              "pos_hi": np.arange(1, 5)}]))
    with IndexService(path, device="cpu") as svc:
        assert svc.device.type == "cpu" and svc.device_active
        assert svc.lookup(keys[:10]).shape == (10, 2)
        assert svc.stats.device_batches == 1


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    planes = fd.pack_prefix([{"kind": "step",
                              "keys": np.arange(0, 400, 4, dtype=np.uint64),
                              "pos_lo": np.arange(100) * 8,
                              "pos_hi": np.arange(1, 101) * 8}])
    mod = fd.FusedDescent(planes, device="cpu")
    q = torch.arange(0, 500, 3, dtype=torch.int32)
    before = K.launches()
    lo, hi = mod(q)                        # CPU tensor: the plain version
    assert lo.shape == (1, len(q)) and K.launches() == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_descent_cuda(q, *(getattr(mod, n) for n in fd.ops.PLANES))
    with pytest.raises(ValueError):
        mod(q.to("meta"))
    assert K.launches() == before


def test_entry_points_of_the_tuner_need_a_card_unless_told_otherwise(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(1, 5_001, dtype=np.uint64) * 7919
    D = KeyPositions.fixed_record(keys, 16)
    bs = make_builders(lam_low=2**10, lam_high=2**16, base=4.0)
    prof = PROFILES["azure_ssd"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepEngine(bs, prof, TuneStats())
    for strategy in (airtune, beam_search, brute_force):
        # the legacy loop (sweep=False) never builds an engine: it checks
        # the backend and the device all the same
        for sweep in (True, False):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                strategy(D, prof, bs, sweep=sweep)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                strategy(D, prof, bs, sweep=sweep, score_backend="pallas")
            with pytest.raises(ValueError, match="score_backend"):
                strategy(D, prof, bs, sweep=sweep, score_backend="tpu",
                         device="cpu")
            cpu = strategy(D, prof, bs, sweep=sweep, device="cpu")
            exact = strategy(D, prof, bs, sweep=sweep, score_backend="numpy")
            assert cpu.cost == pytest.approx(exact.cost, rel=1e-6)


@pytest.mark.parametrize("lib", LIBS, ids=lambda lib: lib.name)
def test_failed_build_raises(lib, tmp_path, monkeypatch):
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_cuda, "nvcc", lambda: shutil.which("false") or "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.build()
    assert lib._lib is None
    monkeypatch.undo()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.nvcc()


@pytest.mark.parametrize("lib", LIBS, ids=lambda lib: lib.name)
def test_build_is_keyed_by_the_source(lib, tmp_path, monkeypatch):
    first = lib.library_path()
    assert first.parent.parent == _cuda.BUILD_ROOT
    assert _cuda.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    assert lib.source == _cuda.CSRC / f"{lib.name}.cu" and lib.source.exists()
    assert all(f in lib.flags for f in ("-gencode",
                                        "arch=compute_90a,code=sm_90a"))
    src = tmp_path / f"{lib.name}.cu"
    src.write_bytes(lib.source.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(lib, "source", src)
    assert lib.library_path() != first
    # no two kernels share a library
    assert len({x.library_path() for x in LIBS}) == len(LIBS)


def _run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_chip_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_facade_entry_points_need_a_card_unless_told_otherwise(small_index,
                                                               monkeypatch):
    from repro_torch.api import Index, TuneSpec
    from repro_torch.kernels import index_lookup as il
    path, keys = small_index
    D = KeyPositions.fixed_record(keys, 16)
    spec = TuneSpec(lam_low=2**10, lam_high=2**14, lam_base=4.0, k=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Index.tune(D, "azure_ssd", spec).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Index.open(path).serve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        il.device_arrays_from_design(demo_serving_design(D))
    idx = Index.tune(D, "azure_ssd", spec, device="cpu").build()
    assert idx.result.stats.est_batches >= 0
    with Index.open(path, device="cpu").serve() as svc:
        assert svc.device.type == "cpu" and svc.device_active
    layers = il.device_arrays_from_design(demo_serving_design(D),
                                          device="cpu")
    before = [lib.launches() for lib in IK.LIBS]
    lo, hi = il.traverse_index(layers, torch.from_numpy(
        keys[:50].astype(np.int32)))
    assert lo.shape == (50,) and [lib.launches() for lib in IK.LIBS] \
        == before


def test_llm_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api
    from repro_torch.models.transformer import Transformer, init_cache
    cfg = get_config("qwen3-14b", smoke=True).scaled(dtype="float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: api.init_params(cfg, 0),
                 lambda: Transformer(cfg),
                 lambda: init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.run(cfg, params, steps=2, max_len=8)
    before = (DK.launches(), AK.launches())
    res = launcher.run(cfg, params, steps=2, max_len=8, device="cpu")
    assert res.stats["device"] == "cpu" and len(res.feeds) == 2
    assert (DK.launches(), AK.launches()) == before
