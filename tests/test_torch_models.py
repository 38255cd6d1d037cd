"""The port's configs and models against the JAX package's, on the same
parameters (carried across with ``params_from_numpy``) and the same
numpy-seeded tokens (and whisper's frames, llava's patch embeddings), at
the SMOKE sizes of all ten configs: the dense, MoE, VLM, hybrid, RWKV and
audio families.

Tolerances, over max |logit| of the JAX side: float32 1e-4 (the two
frameworks sum in other orders through two layers); bfloat16 3e-2 (the
frameworks round activations to bf16 at other places, and the port's
decode attention computes in float32 where the JAX package's feeds bf16
to its einsums), with top-1 equal wherever the JAX top-2 margin exceeds
that.  Decode against the port's own prefill: 5e-3 absolute, as
``tests/test_models_smoke.py`` holds the JAX package (MoE at the capacity
factor E / k, where no token is dropped: the JAX test leaves MoE out for
the drops).
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
from repro_torch.models import params as P
from repro_torch.models.convert import (params_from_numpy, params_tree,
                                        tensor_from_numpy)
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve import make_decode_step, make_prefill_step

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ARCHS = list(tconfigs.ARCHS)             # all ten SMOKE configs
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


def _batch(cfg, seed=0, shape=(B, S)):
    """Tokens and the family's stub inputs as numpy: whisper's frames,
    llava's patch embeddings at distinct positions."""
    rng = np.random.default_rng(seed + 100)
    batch = {"tokens": _tokens(cfg, seed, shape)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (shape[0], cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        n = min(cfg.n_patches, shape[1] // 2)
        batch["patch_embeds"] = 0.05 * rng.standard_normal(
            (shape[0], n, cfg.d_model)).astype(np.float32)
        batch["patch_positions"] = np.stack(
            [rng.choice(shape[1], n, replace=False)
             for _ in range(shape[0])]).astype(np.int32)
    return batch


def _jbatch(cfg, batch):
    return {k: jnp.asarray(v).astype(cfg.jdtype) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in batch.items()}


def _tbatch(cfg, batch):
    return {k: torch.from_numpy(v).to(cfg.torch_dtype)
            if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _frames(batch, convert):
    return convert(batch["frames"]) if "frames" in batch else None


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
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_every_leaf_exactly(pair, arch, dtype):
    jc, jp, tc, tp = pair(arch, dtype)
    tree = jax.tree.map(np.asarray, jp)
    assert api.param_specs(tc).keys() == tree.keys()
    n = 0
    for path, shape, params, stacked in P.leaves(tp):
        want = tree
        for key in path:
            want = want[key]
        assert want.shape == shape, path
        for i, got in enumerate(params):
            assert got.dtype == tc.torch_dtype
            np.testing.assert_array_equal(
                got.float().numpy(),
                (want[i] if stacked else want).astype(np.float32))
        n += 1
    assert n == len(jax.tree.leaves(tree))
    back = params_tree(tc, tp)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                          jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32), err_msg=str(kp))
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
    batch = _batch(jc)
    want, jaux = japi.forward_train(jc, jp, _jbatch(jc, batch))
    got, aux = api.forward_train(tc, tp, _tbatch(tc, batch))
    assert got.shape == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    if tc.n_experts:        # the load-balancing loss, averaged over layers
        assert float(aux) == pytest.approx(float(jaux),
                                           rel=TOL[dtype] / 10)
    else:
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
    batch = _batch(jc, 1)
    want = j_prefill_step(jc)(jp, _jbatch(jc, batch))
    got = make_prefill_step(tc)(tp, _tbatch(tc, batch))
    assert got.shape == (B, tc.padded_vocab)
    _agree(got.float().numpy()[:, :jc.vocab],
           np.asarray(want, np.float32)[:, :jc.vocab], dtype)


def _router_margins(monkeypatch):
    """Record the smallest top-k router margin (in logits) of each call of
    the port's MoE FFN."""
    from repro_torch.models import transformer
    real, seen = transformer.moe_ffn, []

    def moe_ffn(x, router_w, *w, top_k, capacity_factor):
        top = (x.float() @ router_w.float()).topk(top_k + 1, dim=-1).values
        seen.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return real(x, router_w, *w, top_k=top_k,
                    capacity_factor=capacity_factor)
    monkeypatch.setattr(transformer, "moe_ffn", moe_ffn)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_by_step_matches_jax(pair, arch, dtype, monkeypatch):
    """MoE routing is compared first: a step where some token's top-k
    router margin lies within the dtype's limit (in logits) may route
    another expert in the two frameworks (the JAX package compiles its
    bf16 decode with excess precision), and one rerouted token's FFN
    output differs entirely; such a step's logits, and its cache entry,
    are held to being finite only."""
    jc, jp, tc, tp = pair(arch, dtype)
    margins = _router_margins(monkeypatch)
    batch = _batch(jc, 2)
    toks = batch["tokens"]
    jstate = japi.init_decode_state(
        jc, jp, B, MAX, frames=_frames(batch, lambda f: jnp.asarray(
            f).astype(jc.jdtype)))
    state = api.init_decode_state(
        tc, tp, B, MAX, frames=_frames(batch, lambda f: torch.from_numpy(
            f).to(tc.torch_dtype)))
    assert {k: v.shape for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in jstate.items()}
    jdec, dec = jax.jit(j_decode_step(jc)), make_decode_step(tc)
    sure = np.ones(MAX, bool)
    for t in range(S):
        want, jstate = jdec(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jstate, t)
        del margins[:]
        got, state = dec(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                         state, t)
        got = got.float().numpy()[:, :jc.vocab]
        sure[t] = min(margins, default=np.inf) > TOL[dtype]
        if sure[t]:
            _agree(got, np.asarray(want, np.float32)[:, :jc.vocab], dtype)
        else:
            assert np.isfinite(got).all()
    assert sure[:S].sum() >= S - 2
    # the state holds the JAX state's values (a cache written in place)
    for name, want in jstate.items():
        got, want = state[name].float().numpy(), np.asarray(want, np.float32)
        if name in ("k", "v") and tc.n_experts:      # (L, B, H, Smax, hd)
            got, want = got[:, :, :, sure], want[:, :, :, sure]
        np.testing.assert_allclose(got, want, atol=TOL[dtype] * 10,
                                   rtol=TOL[dtype], err_msg=name)


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
    if tc.n_experts:
        tc = tc.scaled(capacity_factor=tc.n_experts / tc.top_k)
    batch = _tbatch(tc, _batch(tc, 3))
    batch.pop("patch_embeds", None)          # patches enter at prefill only
    batch.pop("patch_positions", None)
    toks = batch["tokens"]
    ref, _ = api.forward_train(tc, tp, batch)
    state = api.init_decode_state(tc, tp, B, MAX, frames=batch.get("frames"))
    errs = []
    for t in range(S):
        d, state = api.forward_decode(tc, tp, {"tokens": toks[:, t:t + 1]},
                                      state, t)
        errs.append(float((d[:, 0] - ref[:, t]).abs().max()))
    assert max(errs) < 5e-3, max(errs)


MULTI_ARCHS = [a for a in ARCHS if a not in ("rwkv6_7b", "zamba2_1p2b")]
PROMPT = 4                               # tokens decoded one by one first


def _routed_as_jax(monkeypatch):
    """Route the port's MoE FFN as the JAX package routes: each call of the
    JAX package's ``moe_ffn`` sends the top-k experts of its router out
    through an ordered debug callback (what it computes is unchanged), and
    the port's next ``moe_ffn`` call takes them in place of its own top-k,
    its gates its own probabilities at those experts."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttransformer
    real_j, real_t, real_route = (jtransformer.moe_ffn,
                                  ttransformer.moe_ffn, tlayers._route)
    chosen, pending = [], []

    def j_moe_ffn(x, router_w, *w, top_k, capacity_factor):
        probs = jax.nn.softmax(x.astype(jnp.float32)
                               @ router_w.astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda e: chosen.append(np.array(e)),
                           jax.lax.top_k(probs, top_k)[1], ordered=True)
        return real_j(x, router_w, *w, top_k=top_k,
                      capacity_factor=capacity_factor)

    def t_moe_ffn(*a, **kw):
        pending.append(torch.from_numpy(chosen.pop(0)).long())
        return real_t(*a, **kw)

    def route(x, router_w, top_k):
        probs, gates, experts = real_route(x, router_w, top_k)
        if pending:
            experts = pending.pop().to(x.device)
            gates = probs.gather(-1, experts)
        return probs, gates, experts
    monkeypatch.setattr(jtransformer, "moe_ffn", j_moe_ffn)
    monkeypatch.setattr(ttransformer, "moe_ffn", t_moe_ffn)
    monkeypatch.setattr(tlayers, "_route", route)
    return chosen


@pytest.mark.parametrize("arch", MULTI_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_token_decode_matches_jax(pair, arch, dtype, monkeypatch):
    """The eight families whose decode takes several new tokens a step:
    a prompt decoded token by token, then Sq = 2, 3 and 5 new tokens at
    once (no mask among them, as in the JAX package), from the same
    carried parameters and state, against the JAX package's
    ``forward_decode`` at the Sq = 1 tests' tolerance, every step.  The
    MoE families in bf16 are routed as the JAX package routes: the two
    frameworks' bf16 router logits differ by about that tolerance, so a
    near tie may pick another expert, and one rerouted token changes
    every new token's attention (and, with up to ten tokens over four
    experts, the capacity drops); in float32 they route themselves."""
    jc, jp, tc, tp = pair(arch, dtype)
    chosen = _routed_as_jax(monkeypatch) \
        if tc.n_experts and dtype == "bfloat16" else None
    steps = (2, 3, 5)
    batch = _batch(jc, 4, (B, PROMPT + sum(steps)))
    toks = batch["tokens"]
    frames = batch.get("frames")
    jstate = japi.init_decode_state(jc, jp, B, MAX, frames=None if frames
                                    is None else jnp.asarray(frames).astype(
                                        jc.jdtype))
    state = api.init_decode_state(tc, tp, B, MAX, frames=None if frames is
                                  None else torch.from_numpy(frames).to(
                                      tc.torch_dtype))
    jdec = jax.jit(lambda p, b, st, t: japi.forward_decode(jc, p, b, st, t))
    pos = 0
    for n in (1,) * PROMPT + steps:
        chunk = toks[:, pos:pos + n]
        want, jstate = jdec(jp, {"tokens": jnp.asarray(chunk)}, jstate, pos)
        if chosen is not None:
            jax.effects_barrier()
            assert len(chosen) == tc.n_layers
        got, state = api.forward_decode(tc, tp,
                                        {"tokens": torch.from_numpy(chunk)},
                                        state, pos)
        assert got.shape == (B, n, tc.padded_vocab)
        if chosen is not None:
            assert not chosen
        got = got.float().numpy()[..., :jc.vocab]
        _agree(got, np.asarray(want, np.float32)[..., :jc.vocab], dtype)
        pos += n


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b"])
def test_multi_token_decode_raises_in_both_packages(pair, arch):
    """RWKV6 and Zamba2 step their non-chunked scans one token at a time:
    the JAX package's decode takes the first of several new tokens
    (``[:, 0]``) and fails to reshape; the port's raises first."""
    jc, jp, tc, tp = pair(arch, "float32")
    toks = _tokens(jc, 6, (B, 3))
    jstate = japi.init_decode_state(jc, jp, B, MAX)
    with pytest.raises(TypeError):
        japi.forward_decode(jc, jp, {"tokens": jnp.asarray(toks)}, jstate, 0)
    state = api.init_decode_state(tc, tp, B, MAX)
    with pytest.raises(ValueError, match="non-chunked scan"):
        api.forward_decode(tc, tp, {"tokens": torch.from_numpy(toks)},
                           state, 0)


def test_unported_families_and_decode_cases_raise():
    """Every family runs and decodes one token; several new tokens a step
    give their logits in the transformer families and whisper and raise
    in the two with a non-chunked scan; a position past the cache raises;
    an unknown family raises."""
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch, smoke=True).scaled(dtype="float32")
        params = api.init_params(cfg, 0, device="cpu")
        state = api.init_decode_state(cfg, params, 1, 8)
        assert api.decode_state_specs(cfg, 1, 8).keys() == state.keys()
        logits, state = api.forward_decode(
            cfg, params, {"tokens": torch.ones(1, 1, dtype=torch.int32)},
            state, 0)
        assert logits.shape == (1, 1, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
        two = {"tokens": torch.ones(1, 2, dtype=torch.int32)}
        if arch in ("rwkv6_7b", "zamba2_1p2b"):
            with pytest.raises(ValueError, match="non-chunked scan"):
                api.forward_decode(cfg, params, two, state, 1)
        else:
            logits, state = api.forward_decode(cfg, params, two, state, 1)
            assert logits.shape == (1, 2, cfg.padded_vocab)
            assert bool(torch.isfinite(logits).all())
        if cfg.family != "ssm":              # rwkv keeps no positions
            with pytest.raises(ValueError, match="outside a cache"):
                api.forward_decode(
                    cfg, params,
                    {"tokens": torch.ones(1, 1, dtype=torch.int32)}, state,
                    8)
    with pytest.raises(ValueError, match="family"):
        api.init_params(tconfigs.get_config("qwen3_14b", smoke=True)
                        .scaled(family="mlp"), 0, device="cpu")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_positions_past_the_decoder_table_match_jax(pair, dtype):
    """Whisper's decoder has 4,096 position rows; a step past them takes
    the last row, as the JAX package's gather clamps its indices (a
    32,768-token cache reaches there)."""
    jc, jp, tc, tp = pair("whisper_small", dtype)
    pos, cap = 4094, 4100
    toks = _tokens(jc, 8, (B, 3))
    frames = _batch(jc, 8)["frames"]
    jstate = japi.init_decode_state(jc, jp, B, cap, frames=jnp.asarray(
        frames).astype(jc.jdtype))
    state = api.init_decode_state(tc, tp, B, cap, frames=torch.from_numpy(
        frames).to(tc.torch_dtype))
    want, _ = japi.forward_decode(jc, jp, {"tokens": jnp.asarray(toks)},
                                  jstate, pos)
    got, _ = api.forward_decode(tc, tp, {"tokens": torch.from_numpy(toks)},
                                state, pos)
    _agree(got.float().numpy()[..., :jc.vocab],
           np.asarray(want, np.float32)[..., :jc.vocab], dtype)
