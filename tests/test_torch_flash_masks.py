"""``models.layers.blocked_attention`` with the JAX package's
``q_offset``, ``kv_length`` and ``block_k``, against the JAX package's
jnp ``blocked_attention`` on the same numpy-seeded inputs, forward and
gradient, on the CPU (the port runs its plain version there; the kernel
is held against it on the card in ``test_torch_flash_masks_cuda.py``).

Tolerances: forward 2e-5 in float32 (the JAX flash tests' limit: the sums
run in another order); gradients 1e-4 absolute against ``jax.grad``
(float32 through two passes over kv blocks).  Intended difference: a
query with no live key (a row of ``kv_length`` 0, a causal query before
every key) is 0 in the port, where the reference returns a
``block_k``-dependent mean of zero-padded values; the comparisons cover
the queries with a live key, and the dead rows are pinned on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blocked_attention as jax_attention
from repro_torch.kernels import _meta
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as AR
from repro_torch.models.layers import attention_grads, blocked_attention

CASES = {
    "end-aligned": dict(B=2, Hq=4, Hkv=2, Sq=24, Skv=40, D=32),
    "offset-inside": dict(B=2, Hq=4, Hkv=2, Sq=24, Skv=300, D=32,
                          q_offset=100),
    "lengths-causal": dict(B=3, Hq=4, Hkv=2, Sq=160, Skv=160, D=16,
                           lengths=(160, 97, 33)),
    "lengths-window-softcap": dict(B=3, Hq=4, Hkv=1, Sq=48, Skv=300, D=32,
                                   window=64, softcap=30.0, q_offset=200,
                                   lengths=(300, 231, 250)),
    "gqa-lengths-offset": dict(B=2, Hq=8, Hkv=2, Sq=40, Skv=520, D=16,
                               q_offset=300, lengths=(520, 341)),
    "noncausal-lengths": dict(B=2, Hq=4, Hkv=4, Sq=30, Skv=70, D=16,
                              causal=False, lengths=(70, 9)),
}
DEAD = {
    "row-of-length-0": dict(B=3, Hq=2, Hkv=1, Sq=20, Skv=64, D=16,
                            lengths=(64, 0, 40)),
    "causal-before-every-key": dict(B=1, Hq=2, Hkv=2, Sq=40, Skv=64, D=16,
                                    q_offset=-16),
    "window-past-the-length": dict(B=2, Hq=2, Hkv=1, Sq=16, Skv=200, D=16,
                                   q_offset=150, window=20,
                                   lengths=(200, 100)),
}


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, Sq, Skv, D = (c[x] for x in ("B", "Hq", "Hkv", "Sq", "Skv",
                                             "D"))
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    do = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    opts = {x: c[x] for x in ("causal", "window", "softcap", "q_offset")
            if x in c}
    lens = None if "lengths" not in c \
        else np.asarray(c["lengths"], np.int32)
    return q, k, v, do, opts, lens


def _live_rows(c, lens):
    """(B, Sq) bool: the queries with a live key."""
    Sq, Skv = c["Sq"], c["Skv"]
    off = c.get("q_offset", Skv - Sq)
    live = AR.live_mask(Sq, Skv, c.get("causal", True), c.get("window"),
                        off, None if lens is None else torch.from_numpy(lens),
                        "cpu")
    return live.expand(c["B"], Sq, Skv).any(dim=-1).numpy()


def _both(q, k, v, opts, lens, block_k):
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **opts,
        kv_length=None if lens is None else jnp.asarray(lens),
        block_k=block_k))
    got = blocked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **opts, kv_length=None if lens is None else torch.from_numpy(lens),
        block_k=block_k).numpy()
    return got, want


@pytest.mark.parametrize("block_k", [128, 1024])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_equals_the_reference(name, block_k):
    c = CASES[name]
    q, k, v, _, opts, lens = _inputs(c, len(name) * 7 + block_k)
    got, want = _both(q, k, v, opts, lens, block_k)
    live = _live_rows(c, lens)
    assert live.all()
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_equal_jax_grad_of_the_reference(name):
    c = CASES[name]
    q, k, v, do, opts, lens = _inputs(c, len(name) * 11)
    jl = None if lens is None else jnp.asarray(lens)

    def loss(q, k, v):
        out = jax_attention(q, k, v, **opts, kv_length=jl, block_k=128)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = blocked_attention(*ins, **opts, block_k=128,
                            kv_length=None if lens is None
                            else torch.from_numpy(lens))
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-4


@pytest.mark.parametrize("name", list(DEAD))
def test_a_query_with_no_live_key_is_zero(name):
    """The intended difference, pinned on both sides: the port's dead
    queries are 0 and pass no gradient; the reference's are the mean of
    every kv block's values, zero padding included (so they move with
    ``block_k``); every other query agrees within 2e-5."""
    c = DEAD[name]
    q, k, v, do, opts, lens = _inputs(c, len(name))
    live = _live_rows(c, lens)
    assert not live.all()
    outs = {}
    for block_k in (16, 128):
        got, want = _both(q, k, v, opts, lens, block_k)
        g, w = got.transpose(0, 2, 1, 3), want.transpose(0, 2, 1, 3)
        assert np.abs(g[live] - w[live]).max() < 2e-5
        assert np.all(g[~live] == 0)
        outs[block_k] = w[~live]
        # the reference's dead query: the values of every block, zero
        # padding included, averaged
        Skv = c["Skv"]
        kb = np.pad(v, ((0, 0), (0, 0), (0, -Skv % block_k), (0, 0)))
        G = c["Hq"] // c["Hkv"]
        mean = np.repeat(kb.reshape(c["B"], c["Hkv"], -1, block_k,
                                    c["D"]).mean(axis=(2, 3)), G, axis=1)
        b_idx = np.nonzero(~live)[0]
        np.testing.assert_allclose(w[~live], mean[b_idx], atol=1e-5)
    assert not np.allclose(outs[16], outs[128])
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    dead_do = np.where(live[:, None, :, None], 0.0, do).astype(np.float32)
    out = blocked_attention(*ins, **opts, kv_length=None if lens is None
                            else torch.from_numpy(lens))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(dead_do))
    assert all(float(g.abs().max()) == 0.0 for g in grads)


def test_the_kernel_op_takes_the_masks_and_refuses_what_it_must():
    c = CASES["gqa-lengths-offset"]
    q, k, v, _, opts, lens = _inputs(c, 5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lens)
    got = fa.flash_attention(tq, tk, tv, q_offset=300, kv_length=tl)
    want = fa.attention_ref(tq, tk, tv, q_offset=300, kv_length=tl)
    assert torch.equal(got, want)
    blocked = fa.attention_ref(tq, tk, tv, q_offset=300, kv_length=tl,
                               block_k=64)
    assert float((blocked - want).abs().max()) < 2e-6
    # end-aligned and causal with more queries than keys still raises;
    # an explicit offset places them (the first ones see no key)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        fa.flash_attention(tq[:, :, :40], tk[:, :, :20], tv[:, :, :20])
    out = fa.flash_attention(tq[:, :, :40], tk[:, :, :20], tv[:, :, :20],
                             q_offset=-5)
    assert torch.all(out[:, :, :5] == 0) and torch.all(out[:, :, 5:] != 0)


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", [
    (16, 16, True, None, None), (16, 40, True, None, 3),
    (16, 40, True, 5, 30), (16, 40, False, 7, -3), (50, 40, True, None, -20),
    (16, 40, False, None, 100), (8, 40, True, 4, 60)])
def test_live_pairs_count_the_mask(Sq, Skv, causal, window, q_offset):
    off = Skv - Sq if q_offset is None else q_offset
    want = int(AR.live_mask(Sq, Skv, causal, window, off, None,
                            "cpu").sum())
    assert FO.live_pairs(Sq, Skv, causal, window, q_offset) == want


def test_the_meta_branch_books_a_call_with_lengths_at_every_key():
    B, Hq, Hkv, Sq, Skv, D = 2, 8, 2, 64, 512, 128
    q = torch.empty(B, Hq, Sq, D, device="meta")
    k = torch.empty(B, Hkv, Skv, D, device="meta")
    lens = torch.empty(B, dtype=torch.int32, device="meta")
    with _meta.recording([]) as booked:
        out = fa.flash_attention(q, k, k, q_offset=256, kv_length=lens)
    assert out.shape == q.shape and out.device.type == "meta"
    (b,) = booked
    assert b.flops == 4 * D * B * Hq * FO.live_pairs(Sq, Skv, True, None,
                                                     256)
    assert b.flops == 4 * D * B * Hq * (Sq * 257 + Sq * (Sq - 1) // 2)


def test_the_models_attention_sees_no_change_at_its_default():
    """The models call ``blocked_attention`` end-aligned with no lengths:
    the result is the kernel op's, bit for bit, as before the masks."""
    c = CASES["end-aligned"]
    q, k, v, _, _, _ = _inputs(c, 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert torch.equal(blocked_attention(tq, tk, tv),
                       fa.attention_ref(tq, tk, tv))
    g = attention_grads(tq, tk, tv, tq, q_offset=None)
    h = attention_grads(tq, tk, tv, tq, q_offset=c["Skv"] - c["Sq"])
    assert all(torch.equal(a, b) for a, b in zip(g, h))
