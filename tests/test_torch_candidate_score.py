"""The port's candidate scorer on the CPU against the JAX package's: the
plain PyTorch version (float32) against the reference's float64 numpy
oracle and its Pallas kernel in interpret mode, as the reference's own
``tests/test_sweep.py`` runs it, at rtol 3e-5 (that file's tolerance for
its device scorers); the float64 paths bit for bit.  Inputs: numpy-seeded
widths and weights.  Also: the dispatch sends a tier that does not fold to
the exact numpy evaluator, and a failure on the device path propagates
where the reference quietly scores on numpy instead."""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels.candidate_score import ops as ref_ops
from repro.kernels.candidate_score import (affine_candidate_scores as
                                           ref_affine_candidate_scores)
from repro.kernels.candidate_score import candidate_scores as ref_candidate_scores

import repro_torch.core as P
from repro_torch.kernels import candidate_score as cs
from repro_torch.kernels.candidate_score import kernel as CK
from repro_torch.kernels.candidate_score import ops

TIERS = {
    "azure_ssd": lambda m: m.PROFILES["azure_ssd"],
    "azure_nfs": lambda m: m.PROFILES["azure_nfs"],
    "cached": lambda m: m.CachedProfile(backing=m.PROFILES["azure_ssd"],
                                        hit_rate=0.5),
    "objective": lambda m: m.ObjectiveProfile(base=m.PROFILES["azure_ssd"],
                                              p=0.99, weight=1.0),
    "uniform": lambda m: m.AffineUniformProfile(1e-4, 3e-4, 1e8, 4e8),
}
SHAPES = [(1, 1), (5, 700), (8, 128), (9, 129), (39, 4097)]


def _inputs(C, S, seed=1):
    rng = np.random.default_rng(seed * 1009 + C * 31 + S)
    return (rng.uniform(16.0, 1e6, size=(C, S)),
            rng.uniform(0.5, 4.0, size=S))


@pytest.mark.parametrize("C,S", SHAPES)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_plain_version_matches_reference_oracle_and_pallas(C, S, tier):
    W, wt = _inputs(C, S)
    ell, inv_bw = P.affine_coefficients(TIERS[tier](P))
    assert (ell, inv_bw) == R.affine_coefficients(TIERS[tier](R))
    ref = ref_affine_candidate_scores(W, wt, ell, inv_bw, backend="numpy")
    pallas = ref_affine_candidate_scores(W, wt, ell, inv_bw,
                                         backend="pallas", interpret=True)
    got = cs.affine_scores_torch(torch.from_numpy(W.astype(np.float32)),
                                 torch.from_numpy(wt.astype(np.float32)),
                                 ell, inv_bw)
    assert got.dtype == torch.float32 and got.shape == (C,)
    np.testing.assert_allclose(got.numpy().astype(np.float64), ref,
                               rtol=3e-5)
    np.testing.assert_allclose(got.numpy().astype(np.float64), pallas,
                               rtol=3e-5)
    # the float64 oracle is a copy: bit for bit
    np.testing.assert_array_equal(cs.affine_scores_ref(W, wt, ell, inv_bw),
                                  ref)
    # the numpy-in, numpy-out dispatch on the CPU: the same plain version
    port = cs.affine_candidate_scores(W, wt, ell, inv_bw, backend="cuda",
                                      device="cpu")
    assert port.dtype == np.float64
    np.testing.assert_array_equal(port, got.numpy().astype(np.float64))
    np.testing.assert_array_equal(
        cs.affine_candidate_scores(W, wt, ell, inv_bw, backend="numpy"), ref)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_dispatch_matches_reference_dispatch(tier):
    W, wt = _inputs(7, 1023)
    port = cs.candidate_scores(W, wt, TIERS[tier](P), device="cpu")
    ref = ref_candidate_scores(W, wt, TIERS[tier](R), backend="pallas")
    np.testing.assert_allclose(port, ref, rtol=3e-5)
    exact = R.batched_mean_read_costs(W, wt, TIERS[tier](R))
    np.testing.assert_allclose(port, exact, rtol=3e-5)
    np.testing.assert_array_equal(
        cs.candidate_scores(W, wt, TIERS[tier](P), backend="numpy"), exact)


@pytest.mark.parametrize("tier", ["measured", "distributional",
                                  "cached-measured"])
def test_a_tier_that_does_not_fold_goes_to_the_exact_numpy_path(tier):
    def make(m):
        measured = m.MeasuredProfile((256.0, 4096.0, 65536.0, 1 << 20),
                                     (1e-4, 2e-4, 9e-4, 4e-3))
        if tier == "measured":
            return measured
        if tier == "distributional":
            return m.DistributionalProfile(
                deltas=(4096.0, 65536.0), means=(1e-4, 3e-4),
                excess=(5e-5, 1e-4))
        return m.CachedProfile(backing=measured, hit_rate=0.5)

    W, wt = _inputs(7, 700)
    assert P.affine_coefficients(make(P)) is None
    engine = P.SweepEngine(P.make_builders(), make(P), P.TuneStats(),
                           device="cpu")
    got = engine._batched_est(W, wt)
    assert engine.stats.est_batches == 0     # nothing went to a device
    np.testing.assert_array_equal(
        got, cs.candidate_scores(W, wt, make(P), device="cpu"))
    want = R.batched_mean_read_costs(W, wt, make(R))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref_candidate_scores(W, wt, make(R), backend="pallas"))


def test_device_failure_propagates_where_the_reference_degrades(monkeypatch):
    W, wt = _inputs(5, 700)

    def broken(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(ops, "affine_scores", broken)
    with pytest.raises(RuntimeError, match="injected device failure"):
        cs.candidate_scores(W, wt, P.PROFILES["azure_ssd"], device="cpu")
    with pytest.raises(RuntimeError, match="injected device failure"):
        P.airtune(P.KeyPositions.fixed_record(
            np.arange(1, 40_001, dtype=np.uint64) * 7919, 16),
            P.PROFILES["azure_ssd"], device="cpu")
    # the reference catches the same failure and scores on numpy, silently
    monkeypatch.setattr(ref_ops, "affine_candidate_scores", broken)
    got = ref_candidate_scores(W, wt, R.PROFILES["azure_ssd"],
                               backend="pallas")
    np.testing.assert_array_equal(
        got, R.batched_mean_read_costs(W, wt, R.PROFILES["azure_ssd"]))


def test_timings_split_the_device_path():
    W, wt = _inputs(9, 2000)
    ell, inv_bw = P.affine_coefficients(P.PROFILES["azure_ssd"])
    scores, split = cs.timed_affine_scores(W, wt, ell, inv_bw, device="cpu")
    assert len(split) == 3 and all(v > 0 for v in split)
    np.testing.assert_array_equal(
        scores, cs.affine_candidate_scores(W, wt, ell, inv_bw, device="cpu"))
    # the sweep engine adds each batch's split to its TuneStats
    engine = P.SweepEngine(P.make_builders(), P.PROFILES["azure_ssd"],
                           P.TuneStats(), device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(engine._batched_est(W, wt), scores)
    st = engine.stats
    assert st.est_batches == 2
    assert min(st.est_copy_seconds, st.est_kernel_seconds,
               st.est_readback_seconds) > 0


def test_wrapper_takes_only_cuda_tensors_and_counts_nothing_else():
    W = torch.ones((3, 5), dtype=torch.float32)
    wt = torch.ones(5, dtype=torch.float32)
    before = CK.launches()
    out = cs.affine_scores(W, wt, 1.0, 2.0)     # CPU tensor: plain version
    torch.testing.assert_close(out, torch.full((3,), 3.0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        CK.affine_scores_cuda(W, wt, 1.0, 2.0)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        cs.affine_scores(W.to("meta"), wt.to("meta"), 1.0, 2.0)
    assert CK.launches() == before


def test_unknown_backends_raise():
    W, wt = _inputs(2, 10)
    for bad in ("pallas", "jnp", "tpu"):
        with pytest.raises(ValueError, match="unknown backend"):
            cs.candidate_scores(W, wt, P.PROFILES["azure_ssd"], backend=bad)
        with pytest.raises(ValueError, match="unknown backend"):
            cs.affine_candidate_scores(W, wt, 1.0, 1.0, backend=bad)


# ---------------------------------------------------------------------------
# the kernel's host-side arithmetic (pure functions of shape and SM count)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,S,sms,want", [
    (39, 65654, 132, 7),        # the tuner's largest shape: ~two blocks an SM
    (1, 65654, 132, 32),        # capped so each split keeps 2,048 elements
    (300, 65654, 132, 1),       # rows alone fill the card
    (7, 127, 132, 1),           # too short to split
    (8, 4096, 16, 2),
])
def test_candidate_score_split_count(C, S, sms, want):
    n = CK.split_count(C, S, sms)
    assert n == want
    assert n == 1 or S // n >= CK.MIN_SPLIT_ELEMS


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 7, 8, 9, 11, 4097, 65654])
@pytest.mark.parametrize("n_split", [1, 2, 7])
def test_candidate_score_splits_read_each_element_once(S, n_split):
    """Every row, at each of the four 16-byte offsets a row can start at,
    is read exactly once over its splits: a scalar head and tail in split
    0, and 16-byte vectors that start aligned (row c starts at element
    c·S) and whose weights stay inside the array."""
    for c in range(4):
        spans = CK.row_spans(c, S, n_split)
        assert len(spans) == n_split
        seen = sorted(x for split in spans for a, b in split
                      for x in range(a, b))
        assert seen == list(range(S))
        A = (-c * S) % 4
        for i, split in enumerate(spans):
            vec = split[2:] if i == 0 else split
            for a, b in vec:
                assert (c * S + a) % 4 == 0 and (b - a) % 4 == 0
                # wt's aligned vectors j and j + 1 end inside the array
                assert A == 0 or (b - 4 - A) + 8 <= S
