"""The port's MoE FFN against the JAX package's, on the same numpy-seeded
inputs and weights: ``moe_ffn`` (top-1 and top-2; T ≥ 512, so that the
tokens route in more than one group; a capacity factor that drops
assignments and one that drops none) and ``aux_load_balance_loss``, in
float32 within rtol 1e-5 / atol 1e-6 (the frameworks sum the products in
other orders), and the routing itself (groups, capacity, kept
assignments) exactly.  Random inputs leave no top-k tie: each case
checks that the router's top-k margins are clear of rounding, so a tie
would show here instead of a mismatch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

CASES = [  # (T, d, ff, E, top_k, capacity_factor)
    (64, 32, 48, 4, 1, 1.25),          # one group
    (512, 32, 48, 4, 1, 1.25),         # two groups
    (768, 32, 48, 8, 2, 1.25),         # three groups, top-2
    (1024, 32, 48, 8, 2, 0.5),         # four groups, many drops
    (512, 32, 48, 16, 1, 16.0),        # E / k: no drops
    (300, 16, 24, 4, 2, 1.0),          # T // 256 = 1 group of 300
    (1000, 16, 24, 4, 1, 1.25),        # 3 groups, stepped down to 2
]


def _inputs(T, d, ff, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    wg = (rng.standard_normal((E, d, ff)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, ff)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((E, ff, d)) / np.sqrt(ff)).astype(np.float32)
    return x, router, wg, wu, wd


def _clear_top_k(x, router, k):
    """No (token, expert) choice within rounding of the next one."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    top = np.sort(logits, axis=-1)[:, ::-1]
    return (top[:, k - 1] - top[:, k]).min() > 1e-4


@pytest.mark.parametrize("T,d,ff,E,k,cf", CASES,
                         ids=lambda v: str(v))
def test_moe_ffn_equals_the_jax_moe(T, d, ff, E, k, cf):
    x, router, wg, wu, wd = _inputs(T, d, ff, E, T + E * 10 + k)
    assert _clear_top_k(x, router, k)
    want = jl.moe_ffn(*map(jnp.asarray, (x, router, wg, wu, wd)), top_k=k,
                      capacity_factor=cf)
    got = tl.moe_ffn(*map(torch.from_numpy, (x, router, wg, wu, wd)),
                     top_k=k, capacity_factor=cf)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("T,d,ff,E,k,cf", CASES,
                         ids=lambda v: str(v))
def test_routing_groups_capacity_and_drops_equal_the_jax_dispatch(T, d, ff,
                                                                  E, k, cf):
    x, router, wg, wu, wd = _inputs(T, d, ff, E, T + E * 10 + k)
    G = tl.moe_groups(T)
    want_G = max(min(jl.MOE_GROUPS, T // 256), 1)
    while T % want_G:
        want_G -= 1
    assert G == want_G and tl.MOE_GROUPS == jl.MOE_GROUPS
    t = T // G
    C = tl.moe_capacity(t, k, cf, E)
    assert C == max(int(t * k * cf / E), 4)
    _, gates, experts = tl._route(torch.from_numpy(x),
                                  torch.from_numpy(router), k)
    out, keep = tl._moe_group_dispatch(
        torch.from_numpy(x).reshape(G, t, d), gates.reshape(G, t, k),
        experts.reshape(G, t, k), *map(torch.from_numpy, (wg, wu, wd)), k,
        cf)
    # the kept assignments: the first C of each expert in token order
    e = experts.reshape(G, t * k).numpy()
    for g in range(G):
        order = np.argsort(e[g], kind="stable")
        rank = np.empty_like(order)
        for ex in range(E):
            rows = order[e[g][order] == ex]
            rank[rows] = np.arange(len(rows))
        assert np.array_equal(keep[g].numpy(), (rank < C)[order])
    drops = int((~keep).sum())
    if cf >= E / k:
        assert drops == 0
    elif cf <= 0.5:
        assert drops > 0


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_in_bfloat16_routes_as_the_jax_moe(k):
    """bf16 inputs and weights: where every top-k choice is clear of bf16
    rounding the outputs agree within 3e-2 of max |out|
    (tests/test_torch_models.py's bf16 limit)."""
    x, router, wg, wu, wd = _inputs(512, 32, 48, 8, 40 + k)
    assert _clear_top_k(x, router, k)
    want = np.asarray(jl.moe_ffn(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, router, wg, wu,
                                                         wd)),
        top_k=k, capacity_factor=1.25), np.float32)
    got = tl.moe_ffn(*(torch.from_numpy(a).to(torch.bfloat16)
                       for a in (x, router, wg, wu, wd)),
                     top_k=k, capacity_factor=1.25).float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (16, 1)])
def test_aux_load_balance_loss_equals_the_jax_loss(E, k):
    x, router, *_ = _inputs(512, 32, 48, E, E * 3 + k)
    want = jl.aux_load_balance_loss(jnp.asarray(x), jnp.asarray(router), k)
    got = tl.aux_load_balance_loss(torch.from_numpy(x),
                                   torch.from_numpy(router), k)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_moe_ffn_gradients_reach_every_input():
    x, router, wg, wu, wd = (torch.from_numpy(a).requires_grad_()
                             for a in _inputs(512, 16, 24, 4, 3))
    out = tl.moe_ffn(x, router, wg, wu, wd, top_k=2, capacity_factor=1.0)
    loss = out.square().sum() + tl.aux_load_balance_loss(x, router, 2)
    grads = torch.autograd.grad(loss, (x, router, wg, wu, wd))
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)
