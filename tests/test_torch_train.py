"""The port's training step against the JAX package's, on the same
parameters (the JAX package's ``init_params``, carried across with
``params_from_numpy``) and the same numpy-seeded batches, at the SMOKE
sizes: qwen3-14b, and gemma2-27b for its sliding window and both
softcaps.

Tolerances.  float32: the loss within rtol 1e-5, every gradient within
rtol 1e-4 / atol 1e-6 (the two frameworks sum in other orders), the
parameters after three AdamW steps within rtol 1e-5 / atol 1e-6.  That
atol is 5.6% of the three steps' summed learning rate (1.8e-5): Adam's
update m̂/(√v̂ + ε) of a gradient element near ε (after the clip) moves
with that element's relative error, and a gradient within the atol of
1e-6 above can differ by a third (gemma2: 7.0e-7 on one embedding
element, the others within rtol 1e-5);
bfloat16: the loss within 2e-2 (the frameworks round activations to bf16
at other places).  The attention gradient alone in float32: 1e-5 of max
|grad|.  The optimizer's float32 scalars: rtol 1e-6 (numpy's float32
``cos`` and ``**`` against XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.train import optimizer as joptim
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launcher
from repro_torch.models import api
from repro_torch.models import layers
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        params_tree)
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                               adamw_update, loss_fn, make_train_step,
                               opt_state_specs)
from repro_torch.train import optimizer as toptim
from repro_torch.train import train_step as tts

ARCHS = ["qwen3_14b", "gemma2_27b"]
B, S = 2, 32           # S past gemma2 SMOKE's window of 16
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(arch, dtype):
    return (jconfigs.get_config(arch, smoke=True).scaled(dtype=dtype),
            tconfigs.get_config(arch, smoke=True).scaled(dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    """(arch, dtype) → (JAX cfg, JAX params, port cfg, numpy tree)."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jc, tc = _cfgs(arch, dtype)
            jp = japi.init_params(jc, jax.random.PRNGKey(7))
            cache[arch, dtype] = (jc, jp, tc, jax.tree.map(np.asarray, jp))
        return cache[arch, dtype]
    return get


def _model(tc, tree):
    return params_from_numpy(tc, tree, device="cpu").requires_grad_(True)


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(tc, model, batch, tcfg=TrainConfig()):
    loss, _ = loss_fn(tc, model, _tbatch(batch), tcfg)
    leaves = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _stacked(grads, name, n_layers):
    return np.stack([grads[f"blocks.{i}.{name}"].float().numpy()
                     for i in range(n_layers)])


@pytest.fixture
def loss_chunk(monkeypatch):
    """Set both packages' LOSS_CHUNK (their loss functions read it)."""
    def set_(n):
        monkeypatch.setattr(jts, "LOSS_CHUNK", n)
        monkeypatch.setattr(tts, "LOSS_CHUNK", n)
    return set_


# ---------------------------------------------------------------------------
# attention's gradient
# ---------------------------------------------------------------------------
GRAD_CASES = [
    dict(B=2, Hq=4, Hkv=2, Sq=24, Skv=24, D=16),
    dict(B=1, Hq=4, Hkv=1, Sq=40, Skv=40, D=32, block_k=16),
    dict(B=1, Hq=2, Hkv=2, Sq=16, Skv=48, D=16, block_k=16),
    dict(B=2, Hq=4, Hkv=2, Sq=40, Skv=40, D=16, window=7, block_k=16),
    dict(B=1, Hq=4, Hkv=2, Sq=33, Skv=33, D=16, softcap=5.0),
    dict(B=1, Hq=6, Hkv=2, Sq=50, Skv=50, D=32, window=20, softcap=3.0,
         block_k=16),
    dict(B=1, Hq=2, Hkv=1, Sq=1, Skv=17, D=16, block_k=8),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_attention_grads_match_jax_autodiff(case):
    case = dict(case)
    b, hq, hkv, sq, skv, d = (case.pop(k) for k in
                              ("B", "Hq", "Hkv", "Sq", "Skv", "D"))
    block_k = case.pop("block_k", 1024)
    opts = dict(causal=True, window=case.pop("window", None),
                softcap=case.pop("softcap", None))
    rng = np.random.default_rng(sq * 31 + skv)
    q, do = (rng.normal(size=(b, hq, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
            for _ in range(2))

    def f(q_, k_, v_):
        return jnp.vdot(jlayers.blocked_attention(q_, k_, v_, block_k=block_k,
                                                  **opts), do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = layers.attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                 block_k=block_k, **opts)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # and through autograd: the Function's forward is the plain version
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.blocked_attention(tq, tk, tv, **opts)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    full = layers.attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                  **opts)
    for a, g in zip(auto, full):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


def test_blocked_attention_records_a_graph_only_when_asked():
    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 1, 8, 16)
    out = layers.blocked_attention(q, k, k)
    assert not out.requires_grad and out.grad_fn is None
    with torch.no_grad():
        assert layers.blocked_attention(q.requires_grad_(), k, k).grad_fn \
            is None
    out = layers.blocked_attention(q, k, k)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # the result is a (B, H, S, D) view of a (B, S, H, D) buffer
    assert out.transpose(1, 2).is_contiguous()


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [512, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax_in_float32(pair, loss_chunk,
                                                      arch, chunk):
    loss_chunk(chunk)
    jc, jp, tc, tree = pair(arch, "float32")
    batch = _batch(tc, 1)
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jts.loss_fn(jc, p, _jbatch(batch), jts.TrainConfig()),
        has_aux=True)(jp)
    tloss, tg = _port_grads(tc, _model(tc, tree), batch)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    jg = jax.tree.map(np.asarray, jg)
    for name in ("embed", "unembed", "final_norm"):
        np.testing.assert_allclose(tg[name].numpy(), jg[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for name, want in jg["blocks"].items():
        np.testing.assert_allclose(_stacked(tg, name, tc.n_layers), want,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


FAMILY_ARCHS = ["llama4_scout_17b_a16e", "zamba2_1p2b", "rwkv6_7b",
                "whisper_small"]


def _family_batch(cfg, seed):
    batch = _batch(cfg, seed)
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(seed + 1).standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _grad_tree(tc, grads):
    """The port's gradients by parameter name → the JAX package's tree."""
    holder = api.empty_params(tc, "cpu")
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    return params_to_numpy(tc, holder)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_loss_and_every_gradient_match_jax_in_float32(pair, arch):
    """One train step's loss and gradients for the MoE (with its aux
    loss), hybrid, RWKV and audio families: the loss and the aux loss
    within rtol 1e-5, each gradient leaf within rtol 1e-4 and 1e-5 of its
    max |grad| (the attention gradient's bound above): the chunked scans'
    exp(±W) factors (|W| past 30 in a SMOKE zamba2 chunk) carry the sum
    order's float32 noise to elements far below a leaf's largest, which an
    absolute 1e-6 does not cover (zamba2's embedding: 3.2e-6 on elements
    of 0.1 with max |grad| 1.09).  S = 32 runs whisper's decoder past its
    32 SMOKE frames."""
    jc, jp, tc, tree = pair(arch, "float32")
    batch = _family_batch(tc, 1)
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: jts.loss_fn(jc, p, _jbatch(batch), jts.TrainConfig()),
        has_aux=True)(jp)
    model = _model(tc, tree)
    loss, metrics = loss_fn(tc, model, _tbatch(batch), TrainConfig())
    leaves = dict(model.named_parameters())
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    aux = float(torch.as_tensor(metrics["aux"]).detach())
    assert aux == pytest.approx(float(jaux["aux"]), rel=1e-5)
    assert (float(jaux["aux"]) > 0) == bool(tc.n_experts)
    got = _grad_tree(tc, grads)
    want = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax_in_bfloat16(pair, arch):
    jc, jp, tc, tree = pair(arch, "bfloat16")
    batch = _batch(tc, 2)
    jloss, _ = jts.loss_fn(jc, jp, _jbatch(batch), jts.TrainConfig())
    tloss, tg = _port_grads(tc, _model(tc, tree), batch)
    assert tloss == pytest.approx(float(jloss), rel=LOSS_TOL["bfloat16"])
    assert all(g.dtype == torch.bfloat16 for g in tg.values())
    assert all(bool(torch.isfinite(g.float()).all()) for g in tg.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax_in_float32(pair, arch):
    jc, jp, tc, tree = pair(arch, "float32")
    jstep = jax.jit(jts.make_train_step(jc, jts.TrainConfig()))
    jopt = joptim.adamw_init(jp, joptim.AdamWConfig())
    model = _model(tc, tree)
    tstep = make_train_step(tc, TrainConfig())
    topt = adamw_init(dict(model.named_parameters()), AdamWConfig())
    for i in range(3):
        batch = _batch(tc, 10 + i)
        jp, jopt, jm = jstep(jp, jopt, _jbatch(batch))
        model, topt, tm = tstep(model, topt, _tbatch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert topt["step"] == int(jopt["step"]) == 3
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tc, model)
    for name in ("embed", "unembed", "final_norm"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for name, w in want["blocks"].items():
        np.testing.assert_allclose(got["blocks"][name], w, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_microbatched_step_matches_single():
    """As tests/test_models_smoke.py holds the JAX package: two
    microbatches of 2 against one batch of 4, parameters within 5e-5; and
    the port's two microbatches against the JAX package's."""
    jc, tc = _cfgs("qwen3_14b", "float32")
    jp = japi.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    batch = _batch(tc, 3, b=4)
    outs = []
    for n in (1, 2):
        tcfg = TrainConfig(microbatches=n)
        model = _model(tc, tree)
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        model, _, m = make_train_step(tc, tcfg)(model, opt, _tbatch(batch))
        outs.append((params_to_numpy(tc, model), float(m["loss"])))
    flat = [jax.tree.leaves(o[0]) for o in outs]
    d = max(float(np.abs(a - b).max()) for a, b in zip(*flat))
    assert d < 5e-5, d
    assert outs[1][1] == pytest.approx(outs[0][1], rel=1e-5)
    jtcfg = jts.TrainConfig(microbatches=2)
    jp2, _, jm = jax.jit(jts.make_train_step(jc, jtcfg))(
        jp, joptim.adamw_init(jp, jtcfg.optimizer), _jbatch(batch))
    assert outs[1][1] == pytest.approx(float(jm["loss"]), rel=1e-5)
    for a, b in zip(flat[1], jax.tree.leaves(jax.tree.map(np.asarray, jp2))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


def test_microbatches_must_divide_the_batch():
    _, tc = _cfgs("qwen3_14b", "float32")
    model = api.init_params(tc, 0, "cpu").requires_grad_(True)
    tcfg = TrainConfig(microbatches=3)
    opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
    with pytest.raises(AssertionError, match="not divisible"):
        make_train_step(tc, tcfg)(model, opt, _tbatch(_batch(tc, 0, b=4)))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def test_remat_recomputes_each_block_and_keeps_the_gradients(monkeypatch):
    _, tc = _cfgs("gemma2_27b", "float32")
    real = layers.flash_attention
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", counting)
    model = api.init_params(tc, 3, "cpu").requires_grad_(True)
    batch = _batch(tc, 4)
    grads = {}
    for remat in (True, False):
        calls.clear()
        _, grads[remat] = _port_grads(tc.scaled(remat=remat), model, batch)
        assert len(calls) == tc.n_layers * (2 if remat else 1)
    for name, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][name], rtol=0, atol=0)


@pytest.mark.parametrize("arch,recomputed", [
    ("whisper_small", ("flash",)),        # encoder and decoder blocks
    ("zamba2_1p2b", ("scan",)),           # mamba layers; not the shared block
    ("rwkv6_7b", ("scan",)),              # every block
    ("llama4_scout_17b_a16e", ("flash",)),
])
def test_family_remat_recomputes_where_the_jax_package_checkpoints(
        monkeypatch, arch, recomputed):
    """With ``cfg.remat`` the backward recomputes exactly the blocks the
    JAX package wraps in ``jax.checkpoint`` (whisper's encoder and decoder
    blocks, zamba2's mamba layers but not its shared attention block,
    every RWKV block, every transformer block), and the gradients are the
    ones without remat, bit for bit."""
    from repro_torch.models import rwkv, ssm
    _, tc = _cfgs(arch, "float32")
    counts = {"flash": 0, "scan": 0}
    real_flash, real_scan = layers.flash_attention, rwkv.chunked_linear_scan

    def flash(*a, **kw):
        counts["flash"] += 1
        return real_flash(*a, **kw)

    def scan(*a, **kw):
        counts["scan"] += 1
        return real_scan(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", flash)
    monkeypatch.setattr(rwkv, "chunked_linear_scan", scan)
    monkeypatch.setattr(ssm, "chunked_linear_scan", scan)
    model = api.init_params(tc, 3, "cpu").requires_grad_(True)
    batch = _family_batch(tc, 4)
    seen, grads = {}, {}
    for remat in (True, False):
        counts.update(flash=0, scan=0)
        _, grads[remat] = _port_grads(tc.scaled(remat=remat), model, batch)
        seen[remat] = dict(counts)
    for kind in ("flash", "scan"):
        factor = 2 if kind in recomputed else 1
        assert seen[True][kind] == factor * seen[False][kind], (kind, seen)
    if arch == "zamba2_1p2b":          # the shared block runs once a pass
        assert seen[True]["flash"] == seen[False]["flash"] == \
            ssm.n_shared_applications(tc)
    for name, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][name], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [1, 100, 10_000])
def test_schedule_equals_the_references(step):
    for ocfg in (AdamWConfig(), AdamWConfig(warmup_steps=0, total_steps=50)):
        jcfg = joptim.AdamWConfig(**dataclasses.asdict(ocfg))
        want = float(joptim._schedule(jnp.int32(step), jcfg))
        assert float(toptim._schedule(step, ocfg)) == pytest.approx(
            want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("step", [1, 100, 10_000])
def test_adamw_update_equals_the_references(step, clip):
    """One update from step − 1: clip, moments, bias correction, decay and
    the schedule; bf16 and f32 parameters, moments in float32."""
    rng = np.random.default_rng(step)
    shapes = {"w": (300, 7), "b": (7,), "big": (70_000, 300)}
    dts = {"w": np.float32, "b": np.float32, "big": np.float32}
    params = {k: rng.normal(size=s).astype(dts[k]) for k, s in shapes.items()}
    gscale = 1.0 if clip else 1e-5
    grads = {k: (rng.normal(size=s) * gscale).astype(np.float32)
             for k, s in shapes.items()}
    m = {k: (rng.normal(size=s) * 1e-3).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.random(size=s) * 1e-4).astype(np.float32)
         for k, s in shapes.items()}
    ocfg = AdamWConfig()
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.int32(step - 1)}
    jp, js, jm = joptim.adamw_update(jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, grads), jstate,
                                     joptim.AdamWConfig())
    tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
    tstate = {"m": {k: torch.from_numpy(x.copy()) for k, x in m.items()},
              "v": {k: torch.from_numpy(x.copy()) for k, x in v.items()},
              "step": step - 1}
    got_p, ts, tm = adamw_update(tp, {k: torch.from_numpy(g)
                                      for k, g in grads.items()},
                                 tstate, ocfg)
    assert got_p is tp and ts["step"] == step == int(js["step"])
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert (float(tm["grad_norm"]) > ocfg.grad_clip) == clip
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                          (ts["v"][k], js["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-9, err_msg=k)


def test_adamw_update_keeps_types_and_bounds_its_temporaries(monkeypatch):
    monkeypatch.setattr(toptim, "UPDATE_ELEMENTS", 64)
    rng = np.random.default_rng(0)
    p = {"e": torch.from_numpy(rng.normal(size=(100, 30)).astype(
        np.float32)).to(torch.bfloat16)}
    # a norm below the clip: the scale is 1 at any block size (the norm's
    # sum order follows the blocks)
    g = {"e": torch.from_numpy(rng.normal(size=(100, 30)).astype(
        np.float32) * 1e-3).to(torch.bfloat16)}
    blocks = list(toptim._row_blocks(p["e"]))
    assert len(blocks) == 50 and all(b.numel() <= 64 for b in blocks)
    state = adamw_init(p, AdamWConfig())
    whole = {k: x.clone() for k, x in p.items()}
    wstate = adamw_init(whole, AdamWConfig())
    adamw_update(p, g, state, AdamWConfig())
    monkeypatch.setattr(toptim, "UPDATE_ELEMENTS", 1 << 24)
    adamw_update(whole, g, wstate, AdamWConfig())
    assert p["e"].dtype == torch.bfloat16
    assert state["m"]["e"].dtype == torch.float32
    assert torch.equal(p["e"], whole["e"])
    assert torch.equal(state["v"]["e"], wstate["v"]["e"])


def test_opt_state_specs_mirror_the_references():
    jc, tc = _cfgs("qwen3_14b", "bfloat16")
    flat = {f"{k}": s for k, s in api.param_specs(tc).items()
            if k != "blocks"}
    specs = opt_state_specs(flat, AdamWConfig())
    jspecs = joptim.opt_state_specs(
        {k: v for k, v in japi.param_specs(jc).items() if k != "blocks"},
        joptim.AdamWConfig())
    for k in flat:
        assert specs["m"][k].shape == jspecs["m"][k].shape
        assert specs["m"][k].dtype == torch.float32
        assert specs["v"][k].shape == jspecs["v"][k].shape
    assert specs["step"].shape == () and specs["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# parameter trees and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_gives_back_the_jax_tree(pair, arch, dtype):
    import ml_dtypes
    _, _, tc, tree = pair(arch, dtype)
    model = params_from_numpy(tc, tree, device="cpu")
    got = params_to_numpy(tc, model, bfloat16=ml_dtypes.bfloat16)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    ptree = params_tree(tc, model)
    assert ptree["blocks"]["wq"].dtype == tc.torch_dtype
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="bfloat16"):
            params_to_numpy(tc, model)


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma2_27b", "glm4_9b",
                                  "deepseek_coder_33b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_specs_equal_the_references(arch, smoke):
    j = japi.param_specs(jconfigs.get_config(arch, smoke))
    t = api.param_specs(tconfigs.get_config(arch, smoke))
    assert jax.tree.structure(t, is_leaf=lambda x: not isinstance(x, dict)) \
        == jax.tree.structure(j)
    for name in ("embed", "unembed", "final_norm"):
        assert t[name].shape == j[name].shape
        assert str(t[name].dtype).removeprefix("torch.") == j[name].dtype.name
    for name, s in j["blocks"].items():
        assert t["blocks"][name].shape == s.shape


@pytest.mark.parametrize("shape", sorted(api.SHAPES))
@pytest.mark.parametrize("arch", ["qwen3_14b", "llava_next_34b",
                                  "whisper_small"])
def test_input_specs_equal_the_references(arch, shape):
    jc, tc = (jconfigs.get_config(arch), tconfigs.get_config(arch))
    j = japi.input_specs(jc, japi.SHAPES[shape])
    t = api.input_specs(tc, api.SHAPES[shape])
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].shape == j[k].shape
        assert str(t[k].dtype).removeprefix("torch.") == j[k].dtype.name


# ---------------------------------------------------------------------------
# serving builds no graph
# ---------------------------------------------------------------------------
def test_serving_builds_no_autograd_graph_with_trainable_params():
    _, tc = _cfgs("qwen3_14b", "float32")
    model = api.init_params(tc, 1, "cpu").requires_grad_(True)
    toks = torch.from_numpy(_batch(tc, 5)["tokens"])
    assert torch.is_grad_enabled()
    logits = make_prefill_step(tc)(model, {"tokens": toks})
    assert not logits.requires_grad and logits.grad_fn is None
    state = api.init_decode_state(tc, model, B, 8)
    out, state = make_decode_step(tc)(model, {"tokens": toks[:, :1]}, state, 0)
    assert not out.requires_grad
    assert not any(t.requires_grad for t in state.values())
    res = launcher.run(tc, model, steps=4, max_len=8, device="cpu",
                       keep_logits=True)
    assert len(res.logits) == 4
    # and the training forward does record one
    hidden, _ = api.forward_hidden(tc, model, {"tokens": toks})
    assert hidden.requires_grad
