"""The port's chunked linear scan against the JAX package's chunked scan
and against the sequential oracle (both packages'), on the same
numpy-seeded inputs in float32: the inclusive (Mamba2) and exclusive
(RWKV6, with its bonus on the diagonal) forms, scalar and per-channel
decays, T a multiple of the chunk and not (the zero tail padding), a
carried state.  Tolerance rtol 1e-5 / atol 1e-5 of outputs of order 1
(float32 sums in another order; the chunk factorisation's exp(±W) is
float32 in both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as jls
from repro_torch.models import linear_scan as tls

CASES = [  # (B, H, T, N, P, per-channel decay, inclusive, bonus, chunk)
    (2, 3, 64, 8, 16, False, True, False, 32),
    (1, 2, 50, 8, 8, False, True, False, 32),       # padded tail
    (2, 2, 96, 16, 16, True, False, True, 32),
    (1, 4, 37, 8, 8, True, False, True, 16),        # padded tail
    (2, 2, 40, 8, 12, True, True, False, 8),
    (1, 1, 5, 4, 4, True, False, True, 32),         # shorter than a chunk
]


def _inputs(B, H, T, N, P, channel, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, N)).astype(np.float32)
    k = rng.standard_normal((B, H, T, N)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, H, T, P)).astype(np.float32)
    logw = -rng.uniform(0.01, 1.0, (B, H, T, N if channel else 1)) \
        .astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32) * 0.3
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.1
    return q, k, v, logw, s0, u


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_scan_equals_the_jax_scan_and_both_oracles(case):
    B, H, T, N, P, channel, inclusive, bonus, chunk = case
    q, k, v, logw, s0, u = _inputs(B, H, T, N, P, channel, T * 7 + N)
    ub = u if bonus else None
    jout, jS = jls.chunked_linear_scan(
        *map(jnp.asarray, (q, k, v, logw, s0)), inclusive=inclusive,
        bonus=None if ub is None else jnp.asarray(ub), chunk=chunk)
    t = [torch.from_numpy(a) for a in (q, k, v, logw, s0)]
    tu = None if ub is None else torch.from_numpy(ub)
    out, S = tls.chunked_linear_scan(*t, inclusive=inclusive, bonus=tu,
                                     chunk=chunk)
    assert out.shape == (B, H, T, P) and S.shape == (B, H, N, P)
    assert out.dtype == S.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)
    # both sequential oracles
    seq, Sq = tls.sequential_scan_ref(*t, inclusive=inclusive, bonus=tu)
    jseq, jSq = jls.sequential_scan_ref(
        *map(jnp.asarray, (q, k, v, logw, s0)), inclusive=inclusive,
        bonus=None if ub is None else jnp.asarray(ub))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), Sq.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Sq.numpy(), np.asarray(jSq), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("inclusive", [True, False])
def test_decode_step_equals_the_jax_step(inclusive):
    B, H, N, P = 2, 3, 8, 6
    q, k, v, logw, s0, u = _inputs(B, H, 1, N, P, True, 11)
    args = (q[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], s0)
    jo, jS = jls.linear_scan_decode(*map(jnp.asarray, args),
                                    inclusive=inclusive, bonus=jnp.asarray(u))
    o, S = tls.linear_scan_decode(*map(torch.from_numpy, args),
                                  inclusive=inclusive,
                                  bonus=torch.from_numpy(u))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-6,
                               atol=1e-6)


def test_chunked_scan_continues_from_its_own_state():
    """Two halves, the second from the first's final state, equal the
    whole sequence (the state a prefill hands to decode)."""
    q, k, v, logw, s0, u = (torch.from_numpy(a) for a in
                            _inputs(1, 2, 80, 8, 8, True, 5))
    whole, S = tls.chunked_linear_scan(q, k, v, logw, s0, inclusive=False,
                                       bonus=u)
    a, Sa = tls.chunked_linear_scan(q[:, :, :45], k[:, :, :45], v[:, :, :45],
                                    logw[:, :, :45], s0, inclusive=False,
                                    bonus=u)
    b, Sb = tls.chunked_linear_scan(q[:, :, 45:], k[:, :, 45:], v[:, :, 45:],
                                    logw[:, :, 45:], Sa, inclusive=False,
                                    bonus=u)
    torch.testing.assert_close(torch.cat([a, b], dim=2), whole, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(Sb, S, rtol=1e-5, atol=1e-5)
