"""The port's copy of the HLO text analysis (``repro_torch.launch.
hlo_analysis``) against the JAX package's, on HLO text that JAX compiles
here on the CPU: the scan and nested-scan programs of
``test_hlo_analysis.py``, a while loop whose count XLA cannot see, and one
training-loss step of the qwen3-14b SMOKE model.  No tolerance: both are
the same text functions, so every dict and list must be equal."""
import jax
import jax.numpy as jnp
import pytest

from repro.launch import hlo_analysis as ref
from repro_torch.launch import hlo_analysis as port

from test_hlo_analysis import _scan_matmul


def _while_matmul(n):
    def f(x, w):
        return jax.lax.fori_loop(0, n, lambda i, c: jnp.tanh(c @ w), x)
    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    return jax.jit(f).lower(s, s).compile().as_text()


def _smoke_loss_step():
    from repro.configs import get_config
    from repro.models import api
    from repro.train.train_step import TrainConfig, loss_fn
    cfg = get_config("qwen3-14b", smoke=True)
    params = api.param_specs(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((2, 32), jnp.int32),
             "labels": jax.ShapeDtypeStruct((2, 32), jnp.int32)}
    tcfg = TrainConfig(microbatches=1)

    def step(p, b):
        return jax.grad(lambda p: loss_fn(cfg, p, b, tcfg)[0])(p)
    return jax.jit(step).lower(params, batch).compile().as_text()


PROGRAMS = {
    "scan-1": lambda: _scan_matmul(1),
    "scan-16": lambda: _scan_matmul(16),
    "nested-scan": lambda: _scan_matmul(4, nested=3),
    "fori": lambda: _while_matmul(5),
    "smoke-loss-step": _smoke_loss_step,
}


@pytest.fixture(scope="module")
def texts():
    return {name: make() for name, make in PROGRAMS.items()}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_analyze_and_top_dots_equal_the_references(texts, name):
    hlo = texts[name]
    got, want = port.analyze(hlo), ref.analyze(hlo)
    assert got == want
    assert got["dot_flops"] > 0
    assert port.top_dots(hlo, 7) == ref.top_dots(hlo, 7)
    comps, ref_comps = port.parse_computations(hlo), \
        ref.parse_computations(hlo)
    assert _plain(comps) == _plain(ref_comps)
    assert port.compute_multipliers(comps) == \
        ref.compute_multipliers(ref_comps)


def _plain(comps):
    """Computations as plain values: each instruction's slots."""
    return {name: [tuple(getattr(i, s) for s in i.__slots__) for i in insts]
            for name, insts in comps.items()}


def test_the_scan_counts_are_exact(texts):
    assert port.analyze(texts["scan-16"])["dot_flops"] == 2 * 128**3 * 16
    assert port.analyze(texts["nested-scan"])["dot_flops"] == \
        2 * 128**3 * 12


def test_the_copy_needs_no_jax():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(port))
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert roots <= {"re", "__future__"}
