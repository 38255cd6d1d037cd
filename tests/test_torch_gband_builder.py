"""The port's greedy band builder (``GBand``) against the JAX package's.

The port takes the group boundaries of records wider than the band in one
step and tests short windows one element at a time; both must give the
reference's boundaries exactly.  Same inputs to both packages: sorted
unique keys (numpy seeds below), fixed records of 16 B and 1 KiB, records
of mixed sizes around λ, keys above 2^53 (where neighbours share a
float64), one and two keys; λ from under the smallest record to many
records a band.  The boundaries, the built layers and an Alg. 2 tune over
the default λ grid at 1 KiB records are compared bit for bit.
"""
import numpy as np
import pytest

import repro.core as R
from repro.core import builders as ref_builders

import repro_torch.core as P
from repro_torch.core import builders as port_builders

LAMS = (2.0, 256.0, 1024.0, 1026.0, 2048.0, 4096.0, 2.0**14)


def _layout(name):
    """(keys, lo, hi) of one record layout."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one key":
        keys = np.array([7], dtype=np.uint64)
        sizes = np.array([1024])
    elif name == "two keys":
        keys = np.array([7, 9], dtype=np.uint64)
        sizes = np.array([1024, 1024])
    else:
        n = 20_000
        hi_key = 2**62 if name == "keys above 2^53" else 2**40
        keys = np.unique(rng.integers(1, hi_key, n)).astype(np.uint64)
        if name == "16-byte records":
            sizes = np.full(len(keys), 16)
        elif name == "mixed sizes":
            sizes = rng.choice([8, 100, 600, 1100, 5000], len(keys))
        else:
            sizes = np.full(len(keys), 1024)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return keys, off[:-1], off[1:]


LAYOUTS = ("one key", "two keys", "16-byte records", "1 KiB records",
           "mixed sizes", "keys above 2^53")


def _both(name):
    keys, lo, hi = _layout(name)
    w = np.ones(len(keys))
    return (R.KeyPositions(keys, lo, hi, w),
            P.KeyPositions(keys.copy(), lo.copy(), hi.copy(), w.copy()))


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_gband_boundaries_equal_the_reference(layout, lam):
    Dr, Dp = _both(layout)
    want = ref_builders._gband_starts(Dr, lam)
    got = port_builders._gband_starts(Dp, lam)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ("1 KiB records", "mixed sizes"))
def test_gband_layers_equal_the_reference(layout):
    Dr, Dp = _both(layout)
    for lam in LAMS:
        a = ref_builders.build_gband(Dr, lam)
        b = port_builders.build_gband(Dp, lam)
        for f in ("node_keys", "x1", "y1", "m", "delta"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_tune_over_the_default_grid_at_1k_records_equals_the_reference():
    Dr, Dp = _both("1 KiB records")
    ref = R.airtune(Dr, R.PROFILES["azure_ssd"], R.make_builders(), k=5)
    port = P.airtune(Dp, P.PROFILES["azure_ssd"], P.make_builders(), k=5,
                     score_backend="numpy")
    assert port.cost == ref.cost
    assert port.design.describe() == ref.design.describe()
