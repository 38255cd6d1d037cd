"""The port's configs and dense transformer against the JAX package's, on
the same parameters (carried across with ``params_from_numpy``) and the
same numpy-seeded tokens, at the SMOKE sizes.

Tolerances, over max |logit| of the JAX side: float32 1e-4 (the two
frameworks sum in other orders through two layers); bfloat16 3e-2 (the
frameworks round activations to bf16 at other places, and the port's
decode attention computes in float32 where the JAX package's feeds bf16
to its einsums), with top-1 equal wherever the JAX top-2 margin exceeds
that.  Decode against the port's own prefill: 5e-3 absolute, as
``tests/test_models_smoke.py`` holds the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve.serve_step import make_decode_step as j_decode_step
from repro.serve.serve_step import make_prefill_step as j_prefill_step
from repro_torch import configs as tconfigs
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import make_decode_step, make_prefill_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCHS = ["qwen3_14b", "glm4_9b"]
B, S, MAX = 2, 12, 16


def _cfgs(arch, dtype):
    return (jconfigs.get_config(arch, smoke=True).scaled(dtype=dtype),
            tconfigs.get_config(arch, smoke=True).scaled(dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    """(arch, dtype) → (JAX cfg, JAX params, port cfg, port params)."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jc, tc = _cfgs(arch, dtype)
            jp = japi.init_params(jc, jax.random.PRNGKey(7))
            tree = jax.tree.map(np.asarray, jp)
            cache[arch, dtype] = (jc, jp, tc,
                                  params_from_numpy(tc, tree, device="cpu"))
        return cache[arch, dtype]
    return get


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, shape).astype(np.int32)


def _agree(got, want, dtype):
    """got/want (..., V) logits as float32 numpy, over the real vocab."""
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL[dtype], err
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) / np.abs(want).max() > TOL[dtype]
    assert np.array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_every_config_equals_the_jax_config(arch, smoke):
    j = jconfigs.get_config(arch, smoke)
    t = tconfigs.get_config(arch, smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.padded_vocab, t.n_wkv_heads) == \
        (j.hd, j.padded_vocab, j.n_wkv_heads)
    for active in (False, True):
        assert t.param_count(active) == j.param_count(active)
    assert str(t.torch_dtype).split(".")[-1] == j.jdtype.name
    assert t.scaled(n_layers=3) == dataclasses.replace(t, n_layers=3)


def test_config_registry_and_aliases_equal_the_jax_registry():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs._ALIASES == jconfigs._ALIASES
    for alias in jconfigs._ALIASES:
        assert tconfigs.get_config(alias).name == \
            jconfigs.get_config(alias).name
    assert set(tconfigs.all_configs()) == set(jconfigs.all_configs())


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_every_leaf_exactly(pair, dtype):
    jc, jp, tc, tp = pair("qwen3_14b", dtype)
    tree = jax.tree.map(np.asarray, jp)
    for name in ("embed", "unembed", "final_norm"):
        got = getattr(tp, name)
        assert got.dtype == tc.torch_dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      tree[name].astype(np.float32))
    for name, leaf in tree["blocks"].items():
        for layer, blk in enumerate(tp.blocks):
            np.testing.assert_array_equal(
                getattr(blk, name).float().numpy(),
                leaf[layer].astype(np.float32))
    bits = tensor_from_numpy(tree["embed"])
    assert bits.dtype == tc.torch_dtype


def test_init_params_uses_the_jax_scales():
    cfg = tconfigs.get_config("qwen3_14b", smoke=True).scaled(
        dtype="float32", d_model=256, d_ff=512)
    model = init_params(cfg, 3, device="cpu")
    assert isinstance(model, Transformer) and model.device.type == "cpu"
    assert not any(p.requires_grad for p in model.parameters())
    assert torch.all(model.final_norm == 0)
    for blk in model.blocks:
        assert torch.all(blk.ln1 == 0) and torch.all(blk.ln2 == 0)
    # normal · 1/sqrt(fan_in); a block's (L, hd) norm draws at 1/sqrt(L)
    for got, want in ((model.blocks[0].wq.std(), 256 ** -0.5),
                      (model.unembed.std(), 256 ** -0.5),
                      (model.embed.std(), cfg.padded_vocab ** -0.5),
                      (torch.cat([b.qnorm for b in model.blocks]).std(),
                       cfg.n_layers ** -0.5)):
        assert abs(float(got) / want - 1) < 0.25
    again = init_params(cfg, 3, device="cpu")
    assert torch.equal(again.blocks[1].w_down, model.blocks[1].w_down)
    n = sum(p.numel() for p in model.parameters())
    jcfg = jconfigs.get_config("qwen3_14b", smoke=True).scaled(
        d_model=256, d_ff=512)
    jn = sum(x.size for x in jax.tree.leaves(
        japi.init_params(jcfg, jax.random.PRNGKey(0))))
    assert n == jn


# ---------------------------------------------------------------------------
# forward passes against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax(pair, arch, dtype):
    jc, jp, tc, tp = pair(arch, dtype)
    toks = _tokens(jc)
    want, jaux = japi.forward_train(jc, jp, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward_train(tc, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and got.dtype == tc.torch_dtype
    assert aux == float(jaux) == 0.0
    _agree(got.float().numpy()[..., :jc.vocab],
           np.asarray(want, np.float32)[..., :jc.vocab], dtype)


def test_forward_train_with_window_and_softcaps_matches_jax():
    """gemma2's local/global windows and both softcaps go through the
    port's prefill attention (the flash-attention path) in float32."""
    jc = jconfigs.get_config("gemma2_27b", smoke=True).scaled(
        dtype="float32")
    tc = tconfigs.get_config("gemma2_27b", smoke=True).scaled(
        dtype="float32")
    jp = japi.init_params(jc, jax.random.PRNGKey(2))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(jc, 4, (2, 40))                 # longer than the window
    want, _ = japi.forward_train(jc, jp, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward_train(tc, tp, {"tokens": torch.from_numpy(toks)})
    _agree(got.numpy(), np.asarray(want), "float32")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_step_matches_jax(pair, arch, dtype):
    jc, jp, tc, tp = pair(arch, dtype)
    toks = _tokens(jc, 1)
    want = j_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tc)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, tc.padded_vocab)
    _agree(got.float().numpy()[:, :jc.vocab],
           np.asarray(want, np.float32)[:, :jc.vocab], dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_by_step_matches_jax(pair, arch, dtype):
    jc, jp, tc, tp = pair(arch, dtype)
    toks = _tokens(jc, 2)
    jstate = japi.init_decode_state(jc, jp, B, MAX)
    state = api.init_decode_state(tc, tp, B, MAX)
    assert state["k"].shape == tuple(jstate["k"].shape)
    jdec, dec = j_decode_step(jc), make_decode_step(tc)
    for t in range(S):
        want, jstate = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jstate, t)
        got, state = dec(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                         state, t)
        _agree(got.float().numpy()[:, :jc.vocab],
               np.asarray(want, np.float32)[:, :jc.vocab], dtype)
    # the cache was written in place and holds the JAX cache's values
    np.testing.assert_allclose(state["k"].float().numpy(),
                               np.asarray(jstate["k"], np.float32),
                               atol=TOL[dtype] * 10, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_decode_with_window_and_softcap_matches_jax(dtype):
    """gemma2's decode (local layers windowed at 16, global layers not,
    attention softcap 50, final softcap 30) step by step against the JAX
    package's decode on the same parameters, past the window: 5e-3 of max
    |logit| in float32, as the dense decode is held to its own prefill;
    bfloat16 at the dense tests' limit."""
    jc, tc = _cfgs("gemma2_27b", dtype)
    assert tc.sliding_window == 16 and tc.attn_softcap == 50.0
    jp = japi.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    steps, cap = 24, 32
    toks = _tokens(jc, 5, (B, steps))
    jstate = japi.init_decode_state(jc, jp, B, cap)
    state = api.init_decode_state(tc, tp, B, cap)
    jdec, dec = j_decode_step(jc), make_decode_step(tc)
    tol = {"float32": 5e-3, "bfloat16": TOL["bfloat16"]}[dtype]
    for t in range(steps):
        want, jstate = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jstate, t)
        got, state = dec(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                         state, t)
        w = np.asarray(want, np.float32)[:, :jc.vocab]
        g = got.float().numpy()[:, :jc.vocab]
        assert np.abs(g - w).max() / np.abs(w).max() < tol, t
        assert np.isfinite(g).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(pair, arch):
    jc, jp, tc, tp = pair(arch, "float32")
    toks = torch.from_numpy(_tokens(tc, 3))
    ref, _ = api.forward_train(tc, tp, {"tokens": toks})
    state = api.init_decode_state(tc, tp, B, MAX)
    errs = []
    for t in range(S):
        d, state = api.forward_decode(tc, tp, {"tokens": toks[:, t:t + 1]},
                                      state, t)
        errs.append(float((d[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) < 5e-3, max(errs)


def test_unported_families_and_decode_cases_raise():
    for arch in ("grok1_314b", "rwkv6_7b", "zamba2_1p2b", "whisper_small",
                 "llava_next_34b", "llama4_scout_17b_a16e"):
        cfg = tconfigs.get_config(arch, smoke=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.init_params(cfg, 0, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.decode_state_specs(cfg, 1, 8)
    # gemma2 (window and softcap) decodes: the reference's case of
    # ROADMAP.md F3 gives finite logits of shape (1, 1, vocab)
    g = tconfigs.get_config("gemma2_27b", smoke=True).scaled(dtype="float32")
    gp = api.init_params(g, 0, device="cpu")
    state = api.init_decode_state(g, gp, 1, 8)
    logits, _ = api.forward_decode(
        g, gp, {"tokens": torch.ones(1, 1, dtype=torch.int32)}, state, 0)
    assert logits.shape == (1, 1, g.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    q = tconfigs.get_config("qwen3_14b", smoke=True).scaled(dtype="float32")
    qp = api.init_params(q, 0, device="cpu")
    state = api.init_decode_state(q, qp, 1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.forward_decode(q, qp, {"tokens": torch.ones(1, 2, dtype=torch.int32)},
                           state, 0)
    with pytest.raises(ValueError, match="outside a cache"):
        api.forward_decode(q, qp, {"tokens": torch.ones(1, 1, dtype=torch.int32)},
                           state, 8)


def test_shapes_equal_the_jax_shapes():
    assert {k: dataclasses.asdict(v) for k, v in api.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in japi.SHAPES.items()}
    for arch in jconfigs.ARCHS:
        for name in api.SHAPES:
            assert api.shape_supported(tconfigs.get_config(arch),
                                       api.SHAPES[name]) == \
                japi.shape_supported(jconfigs.get_config(arch),
                                     japi.SHAPES[name])
    spec = api.decode_state_specs(tconfigs.get_config("qwen3_14b"), 4, 64)
    jspec = japi.decode_state_specs(jconfigs.get_config("qwen3_14b"), 4, 64)
    assert spec["k"].shape == tuple(jspec["k"].shape)
    assert str(spec["v"].dtype).split(".")[-1] == jspec["v"].dtype.name
