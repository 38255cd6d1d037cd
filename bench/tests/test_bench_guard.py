"""The import guard and the run's refusals."""
import os
import shutil
import subprocess
import sys

from benchlib import guard
from benchlib.guard import ROOT


def test_forbidden_names_compared_whole():
    assert guard.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) \
        == ["jax", "jaxlib"]
    assert guard.forbidden_modules(["repro.core.lookup"]) == ["repro"]
    assert guard.forbidden_modules(["flax.linen"]) == ["flax"]
    assert guard.forbidden_modules(["repro_torch", "repro_torch.models",
                                    "jaxtyping", "reproduce"]) == []


def test_caches_inside_the_checkout():
    env = guard.cache_env()
    assert env == {"CUDA_CACHE_PATH": str(ROOT / "build" / "cuda_cache")}


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen3-14b.prefill",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_unknown_cell_no_result():
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
