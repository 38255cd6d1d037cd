"""The port's seeded parameter draws against ``jax.random``: threefry2x32
keys and bits, XLA's float32 ``log``/``log1p``/``sqrt``/``erf_inv`` on the
CPU, ``jax.random.normal``, and ``init_params(cfg, seed)`` of every family
at every SMOKE config — all bit-equal (no tolerance).  A
``torch.Generator`` keeps the port's own draw.  And the CPU training
launcher passes its "loss must decrease" check at its defaults.

Inputs: jax keys from ``PRNGKey(0..3)``, numpy-seeded samples (seed 0) of
each function's domain, ``jax.random.uniform`` draws for ``erf_inv``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tlaunch
from repro_torch.models import api, params as P, prng
from repro_torch.models.convert import params_tree, tensor_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The draws are long chains of small elementwise ops: one thread a
    process keeps them quick when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.ascontiguousarray(x, dtype=np.float32).view(np.int32)


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_keys_and_splits_equal_jax(seed):
    k = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == _key(k)
    for n in (1, 2, 5, 33):
        assert prng.split(prng.prng_key(seed), n) == \
            [_key(x) for x in jax.random.split(k, n)]


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 7), (1000, 33)])
def test_normal_equals_jax_at_any_offset(shape):
    key = jax.random.split(jax.random.PRNGKey(3), 4)[2]
    want = _bits(jax.random.normal(key, shape, jnp.float32)).reshape(-1)
    n = want.size
    got = prng.normal(_key(key), 0, n, "cpu")
    np.testing.assert_array_equal(_bits(got), want)
    # a layer of a stacked leaf draws its own range of the flat draw
    cut = n // 3
    tail = prng.normal(_key(key), cut, n - cut, "cpu")
    np.testing.assert_array_equal(_bits(tail), want[cut:])


def test_normal_equals_jax_over_a_million_draws():
    key = jax.random.PRNGKey(0)
    n = 1 << 20
    want = _bits(jax.random.normal(key, (n,), jnp.float32))
    np.testing.assert_array_equal(_bits(prng.normal(_key(key), 0, n, "cpu")),
                                  want)


def _samples(lo, hi, n=1 << 18):
    return np.random.default_rng(0).uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("name,fn,jfn,lo,hi", [
    ("log", prng.xla_log, jnp.log, 1e-7, 1e3),
    ("log1p", prng.xla_log1p, jnp.log1p, -1 + 1e-7, 0.0),
    ("sqrt", prng.xla_sqrt, jnp.sqrt, 5.0, 17.0),
    ("erf_inv", prng.erf_inv, jax.lax.erf_inv, -1 + 1e-7, 1 - 1e-7),
])
def test_xla_functions_equal_jitted_jax(name, fn, jfn, lo, hi):
    x = _samples(lo, hi)
    want = _bits(jax.jit(jfn)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(fn(torch.from_numpy(x))), want,
                                  err_msg=name)


def test_fma_rounds_once():
    f = lambda v: torch.tensor([v], dtype=torch.float32)
    # a·b = 1 + 2^-11 + 2^-24 lies on a float32 midpoint; + 2^-60 puts it
    # above, which a float64 sum would lose before the float32 rounding
    a = b = f(1 + 2.0**-12)
    got = prng.fma(a, b, f(2.0**-60))
    assert float(got) == 1 + 2.0**-11 + 2.0**-23
    assert float(prng.fma(a, b, f(-(2.0**-60)))) == 1 + 2.0**-11
    assert float(prng.fma(f(3.0), f(5.0), f(-15.0))) == 0.0


@pytest.mark.parametrize("n", [2, 4, 8, 16, 24, 64, 80, 256])
def test_linspace_equals_jax(n):
    np.testing.assert_array_equal(_bits(prng.linspace(0.5, 4.0, n)),
                                  _bits(jnp.linspace(0.5, 4.0, n)))


@pytest.mark.parametrize("dtype", ["config", "float32"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_init_params_equals_jax_leaf_for_leaf(arch, dtype):
    jc = jconfigs.get_config(arch, smoke=True)
    tc = tconfigs.get_config(arch, smoke=True)
    if dtype == "float32":
        jc, tc = jc.scaled(dtype=dtype), tc.scaled(dtype=dtype)
    want = jax.tree_util.tree_flatten_with_path(
        japi.init_params(jc, jax.random.PRNGKey(0)))[0]
    got = jax.tree_util.tree_flatten_with_path(
        params_tree(tc, api.init_params(tc, 0, "cpu")))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, w), (_, g) in zip(want, got):
        w = tensor_from_numpy(np.asarray(w))
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_chunked_draw_equals_the_whole(monkeypatch):
    cfg = tconfigs.get_config("zamba2-1.2b", smoke=True)
    whole = api.init_params(cfg, 2, "cpu")
    monkeypatch.setattr(prng, "CHUNK", 1000)   # chunks cross layers
    cut = api.init_params(cfg, 2, "cpu")
    for (name, a), (_, b) in zip(whole.named_parameters(),
                                 cut.named_parameters()):
        assert torch.equal(a, b), name


def test_a_card_draws_in_larger_chunks():
    """A draw's chunk is picked by the device: a card's is larger (its
    ops are launch-bound at the CPU's), both bounded."""
    assert prng.chunk("cpu") == prng.CHUNK
    assert prng.chunk(torch.device("cuda", 0)) == prng.CHUNK_CUDA
    assert prng.CHUNK < prng.CHUNK_CUDA <= 1 << 24


def test_a_generator_keeps_the_ports_own_draw():
    """A ``torch.Generator`` draws each parameter's normal in layout
    order times the rule's float (its numbers before the seed draw
    existed)."""
    cfg = tconfigs.get_config("qwen3-14b", smoke=True).scaled(
        dtype="float32")
    model = api.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(5)
    from repro_torch.models import transformer as T
    for name, item in model.layout.items():
        mods = list(getattr(model, name)) if isinstance(item, P.Stack) \
            else [model]
        shapes = item.shapes if isinstance(item, P.Stack) else {name: item}
        for mod in mods:
            for k, s in shapes.items():
                tree_shape = (item.n, *s) if isinstance(item, P.Stack) \
                    else tuple(s)
                x = torch.randn(tuple(s), generator=gen)
                rule = T._init_rule(k, tree_shape)
                want = torch.zeros(tuple(s)) if callable(rule) \
                    else x * rule.scale
                assert torch.equal(getattr(mod, k), want), k
    seeded = api.init_params(cfg, 5, "cpu")
    assert not torch.equal(seeded.embed, model.embed)


def test_cpu_training_launcher_passes_at_its_defaults(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: the
    seed-0 parameters are the JAX package's, and its closing assertion
    (the last loss below the first) holds."""
    res = tlaunch.main(["--smoke", "--device", "cpu", "--workdir",
                        str(tmp_path)])
    assert res.steps == 20 and len(res.losses) == 20
    assert res.losses[-1] < res.losses[0]
