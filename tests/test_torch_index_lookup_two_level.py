"""The port's plain two-level step lookup and band lookup against the JAX
package, at the widths and queries where the Hopper kernels change
course: segments that end in a partial one (4224 = 33 x 128, 4225), the
phase-9 bottom layer (81,298 entries), the band widths of phase 9 (171,
723) and the cap (4096).

The plain two-level function is the port's level 1 (``segment_bases``)
then level 2 (``segmented_step_lookup_torch``), which the segmented
kernel is held to on the card; on the CPU ``lookup_step_layer`` runs it.
Queries: random stored-key-domain values, below the first key, equal to
every grid key (every 128th key), equal to the last key, above it, and
2^31 − 1.  Oracles: the JAX package's ``lookup_step_layer`` in Pallas
interpret mode and the float64 ``layer.predict`` of its ``StepLayer``,
both exact; for the band, the JAX package's oracle ``band_lookup_ref`` at
every query and its Pallas path (interpret mode) below 2^31 − 1, within
4 (the JAX package's own bound: its kernel and oracle differ by FMA
contraction).  The JAX kernel pads its keys with 2^31 − 1, which a query
of that value counts; the oracle and the port clip the count at P."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels.index_lookup import ops as ref_ops
from repro.kernels.index_lookup import ref as ref_ref

from repro_torch.kernels import index_lookup as il

I32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _queries(rng, keys, n_random):
    """Random queries plus the edge cases of the module docstring."""
    grid = keys[::il.LANE]
    q = np.concatenate([
        rng.integers(0, 2**31 - 2, n_random),
        [0, keys[0] - 1, keys[-1], keys[-1] + 1, I32_MAX],
        grid, grid - 1, rng.choice(keys, 16)])
    return q.astype(np.int32)


def _step_layer(rng, P):
    keys = np.sort(rng.choice(np.arange(1, 2**31 - 2, 997), P,
                              replace=False)).astype(np.int32)
    pos = np.sort(rng.choice(2**30, P + 1, replace=False)).astype(np.int32)
    return keys, pos


@pytest.mark.parametrize("P", [4097, 4224, 4225, 20_000, 81_298])
def test_plain_two_level_equals_the_reference(P):
    rng = np.random.default_rng(P)
    keys, pos = _step_layer(rng, P)
    q = _queries(rng, keys, 64)
    kt, pt, qt = _t(keys), _t(pos), _t(q)
    got = il.segmented_step_lookup_torch(qt, il.segment_bases(kt, qt), kt,
                                         pt[:-1], pt[1:])
    assert got[0].dtype == torch.int32
    # the layer call on CPU tensors runs the same two levels
    for a, b in zip(il.lookup_step_layer(qt, kt, pt), got):
        assert torch.equal(a, b)
    want = ref_ops.lookup_step_layer(jnp.asarray(q), jnp.asarray(keys),
                                     jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    layer = R.StepLayer(piece_keys=keys.astype(np.uint64),
                        piece_pos=pos.astype(np.int64),
                        node_piece_off=np.arange(P + 1, dtype=np.int64))
    lo, hi = layer.predict(q.astype(np.uint64))
    np.testing.assert_array_equal(got[0].numpy(), lo)
    np.testing.assert_array_equal(got[1].numpy(), hi)
    # every query at or above the last key reads the last entry, the
    # clipped repeats of the last segment included
    top = q >= keys[-1]
    assert top.sum() >= 3
    assert np.all(got[0].numpy()[top] == pos[-2])
    assert np.all(got[1].numpy()[top] == pos[-1])


@pytest.mark.parametrize("P", [1, 171, 723, 4096])
def test_plain_band_equals_the_reference(P):
    rng = np.random.default_rng(P + 7)
    nk = np.sort(rng.choice(np.arange(1, 2**31 - 2, 257), P,
                            replace=False)).astype(np.int32)
    x1 = nk.astype(np.float32)
    y1 = np.sort(rng.integers(0, 2**24, P)).astype(np.float32)
    m = rng.uniform(0, 0.01, P).astype(np.float32)
    d = rng.uniform(1, 600, P).astype(np.float32)
    q = _queries(rng, nk, 300)
    got = il.lookup_band_layer(*(_t(a) for a in (q, nk, x1, y1, m, d)))
    for a, b in zip(got, il.band_lookup_torch(
            *(_t(a) for a in (q, nk, x1, y1, m, d)))):
        assert torch.equal(a, b)
    oracle = ref_ref.band_lookup_ref(
        *(jnp.asarray(a) for a in (q, nk, x1, y1, m, d)))
    below = q < I32_MAX
    pallas = ref_ops.lookup_band_layer(
        *(jnp.asarray(a) for a in (q[below], nk, x1, y1, m, d)))
    for g, o, w in zip(got, oracle, pallas):
        g = g.numpy()
        assert g.dtype == np.int32
        assert np.max(np.abs(g.astype(np.int64) - np.asarray(o))) <= 4
        assert np.max(np.abs(g[below].astype(np.int64)
                             - np.asarray(w))) <= 4
    lo, hi = (g.numpy() for g in got)
    assert np.all(hi >= lo + 1)
