"""The hand-written kernels on the card, against their plain PyTorch
versions on the same inputs (numpy seeds).  Fused descent: no tolerance —
the kernel forbids FMA contraction, so it equals the plain version bit
for bit; the same holds for the step, band and segmented-step lookup
kernels, and step rows also equal the float64 ``layer.predict``.
Candidate scoring: rtol 1e-5 to the plain version (the float32
sums are taken in another order) and 3e-5 to the float64 oracle (the JAX
package's own tolerance for its device scorers).  Decode and flash
attention: float32 at the JAX kernel tests' limits (decode 3e-5 on o,
1e-5 on m, l relative 1e-5; flash 2e-5) with TF32 off for the plain
versions, bfloat16 at 2e-2 — float32 sums in another order.  Needs an
NVIDIA card:
run there with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_kernel_cuda.py``; skips on a machine without one.  It
imports only the port, so it runs where jax is not installed."""
import numpy as np
import pytest
import torch

from repro_torch.core import PROFILES, CachedProfile, affine_coefficients
from repro_torch.kernels import candidate_score as cs
from repro_torch.kernels import fused_descent as fd
from repro_torch.kernels.candidate_score import kernel as CK
from repro_torch.kernels.fused_descent import kernel as K
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import index_lookup as il
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.index_lookup import kernel as IK

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _prefix(rng, L, P, mixed):
    layers = []
    for l in range(L):
        n = int(rng.integers(P - 127, P + 1))
        keys = np.concatenate([[1], np.sort(rng.choice(
            np.arange(2, 2**31 - 2, 9973), n - 1, replace=False))])
        if mixed and l % 2:
            # a fitted band layer: each node's line runs to the next node's
            # position, and positions (byte offsets into the layer below)
            # stay under 2^24, the regime band_f32_slack bounds.  A line
            # that climbs far above its own y1 can round past the slack;
            # the disk walk then extends the missed window.
            y1 = np.sort(rng.integers(0, 2**24, n)).astype(np.float64)
            x_next = np.append(keys[1:], 2**31 - 1).astype(np.float64)
            y_next = np.append(y1[1:], 2.0**24)
            layers.append({"kind": "band", "x1": keys.astype(np.uint64),
                           "y1": y1, "m": (y_next - y1) / (x_next - keys),
                           "delta": rng.uniform(1, 600, n)})
        else:
            pos = np.sort(rng.integers(0, 2**30, n + 1))
            layers.append({"kind": "step", "keys": keys.astype(np.uint64),
                           "pos_lo": pos[:-1], "pos_hi": pos[1:]})
    return layers


@pytest.mark.parametrize("L,mixed", [(1, False), (2, True), (4, True)])
@pytest.mark.parametrize("P", [128, 640, 4096])
def test_kernel_equals_plain_version(card, L, mixed, P):
    rng = np.random.default_rng(L * 10_000 + P)
    layers = _prefix(rng, L, P, mixed)
    mod = fd.FusedDescent(fd.pack_prefix(layers), device=card)
    for Q in (1, 255, 4097):
        q = rng.integers(1, 2**31 - 2, Q).astype(np.uint64)
        qt = torch.from_numpy(q.astype(np.int32)).to(card)
        before = K.launches()
        lo, hi = mod(qt)
        torch.cuda.synchronize()
        assert K.launches() == before + 1
        plo, phi = fd.fused_descent_torch(mod.planes(), qt)
        assert torch.equal(lo, plo) and torch.equal(hi, phi)
        rlo, rhi = fd.fused_descent_ref(layers, q)
        for r, lay in enumerate(layers):
            klo, khi = lo[r].cpu().numpy(), hi[r].cpu().numpy()
            if lay["kind"] == "step":
                np.testing.assert_array_equal(klo, rlo[r])
                np.testing.assert_array_equal(khi, rhi[r])
            else:
                assert np.all(klo <= rlo[r]) and np.all(khi >= rhi[r])


def test_kernel_rejects_what_it_does_not_take(card):
    planes = fd.pack_prefix(_prefix(np.random.default_rng(0), 1, 128, False))
    mod = fd.FusedDescent(planes, device=card)
    with pytest.raises(ValueError):
        mod(torch.arange(4, dtype=torch.int64, device=card))
    planes_t = [getattr(mod, n) for n in fd.ops.PLANES]
    with pytest.raises(ValueError):
        K.fused_descent_cuda(torch.arange(4, dtype=torch.int32, device=card),
                             *planes_t[:1], planes_t[1].float(),
                             *planes_t[2:])


@pytest.mark.parametrize("C", [1, 7, 39, 300])
@pytest.mark.parametrize("S", [1, 127, 4097, 65574])
def test_candidate_score_kernel_matches_plain_and_oracle(card, C, S):
    rng = np.random.default_rng(C * 100_003 + S)
    W = rng.uniform(16.0, 1e6, size=(C, S))
    wt = rng.uniform(0.5, 4.0, size=S)
    for prof in (PROFILES["azure_ssd"],
                 CachedProfile(backing=PROFILES["azure_nfs"], hit_rate=0.5)):
        ell, inv_bw = affine_coefficients(prof)
        Wt = torch.from_numpy(W.astype(np.float32)).to(card)
        wtt = torch.from_numpy(wt.astype(np.float32)).to(card)
        before = CK.launches()
        got = cs.affine_scores(Wt, wtt, ell, inv_bw)
        torch.cuda.synchronize()
        assert CK.launches() == before + 1
        plain = cs.affine_scores_torch(Wt, wtt, ell, inv_bw)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.cpu().numpy().astype(np.float64),
                                   cs.affine_scores_ref(W, wt, ell, inv_bw),
                                   rtol=3e-5)


def test_candidate_score_kernel_rejects_what_it_does_not_take(card):
    W = torch.ones((3, 5), dtype=torch.float32, device=card)
    wt = torch.ones(5, dtype=torch.float32, device=card)
    before = CK.launches()
    for bad in (W.double(), W.t(), W[:, :4]):
        with pytest.raises(ValueError):
            CK.affine_scores_cuda(bad, wt, 1.0, 1.0)
    with pytest.raises(ValueError):
        CK.affine_scores_cuda(W, wt[:4], 1.0, 1.0)
    with pytest.raises(ValueError):
        CK.affine_scores_cuda(W, wt.cpu(), 1.0, 1.0)
    assert CK.launches() == before


def _layer(rng, P, band):
    keys = np.concatenate([[1], np.sort(rng.choice(
        np.arange(2, 2**31 - 2, 257), P - 1, replace=False))]).astype(
        np.int32)
    if band:
        y1 = np.sort(rng.integers(0, 2**24, P)).astype(np.float32)
        return (keys, keys.astype(np.float32), y1,
                rng.uniform(0, 0.01, P).astype(np.float32),
                rng.uniform(1, 600, P).astype(np.float32))
    pos = np.sort(rng.integers(0, 2**30, P + 1)).astype(np.int32)
    return keys, pos


def _on(card, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(card)
            for a in arrays]


@pytest.mark.parametrize("P", [1, 2, 31, 32, 33, 64, 127, 128, 1000, 4095,
                               4096, 4097, 20_000])
@pytest.mark.parametrize("Q", [1, 255, 257, 4096, 4097, 1 << 20])
def test_step_lookup_kernels_equal_plain_version(card, P, Q):
    """Both forms of the step kernel's launch (one query a thread; the
    persistent grid at 2^20) and the two-level path past MAX_P, bit for
    bit, with queries below the first key, equal to the last, above it
    and at 2^31 − 1 (which counts the kernel's KEY_PAD padding), then
    stored keys."""
    rng = np.random.default_rng(P * 31 + Q)
    keys, pos = _layer(rng, P, False)
    q = rng.integers(1, 2**31 - 2, Q).astype(np.int32)
    edges = np.concatenate([[0, keys[-1], keys[-1] + 1, 2**31 - 1],
                            keys[:3]]).astype(np.int32)
    q[: min(Q, len(edges))] = edges[: min(Q, len(edges))]
    qt, kt, pt = _on(card, q, keys, pos)
    lib = IK.STEP if P <= il.MAX_VMEM_ENTRIES else IK.SEGMENTED
    before = lib.launches()
    lo, hi = il.lookup_step_layer(qt, kt, pt)
    torch.cuda.synchronize()
    assert lib.launches() == before + 1
    plo, phi = il.lookup_step_layer(*(x.cpu() for x in (qt, kt, pt)))
    assert torch.equal(lo.cpu(), plo) and torch.equal(hi.cpu(), phi)
    if P <= il.MAX_VMEM_ENTRIES:
        # pos_lo and pos_hi as two arrays, not two views of one
        lo2, hi2 = IK.step_lookup_cuda(qt, kt, pt[:-1].clone(),
                                       pt[1:].clone())
        assert torch.equal(lo2, lo) and torch.equal(hi2, hi)
    i = np.maximum(np.searchsorted(keys, q, side="right") - 1, 0)
    np.testing.assert_array_equal(lo.cpu().numpy(), pos[:-1][i])
    np.testing.assert_array_equal(hi.cpu().numpy(), pos[1:][i])


@pytest.mark.parametrize("P", [1, 10, 300, 4096])
@pytest.mark.parametrize("Q", [1, 256, 4097])
def test_band_lookup_kernel_equals_plain_version(card, P, Q):
    rng = np.random.default_rng(P * 17 + Q)
    arrays = _layer(rng, P, True)
    q = rng.integers(1, 2**31 - 2, Q).astype(np.int32)
    ts = _on(card, q, *arrays)
    before = IK.BAND.launches()
    lo, hi = il.lookup_band_layer(*ts)
    torch.cuda.synchronize()
    assert IK.BAND.launches() == before + 1
    plo, phi = il.band_lookup_torch(*ts)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


def test_lookup_kernels_reject_what_they_do_not_take(card):
    rng = np.random.default_rng(0)
    keys, pos = _layer(rng, 64, False)
    qt, kt, pt = _on(card, keys, keys, pos)
    before = [lib.launches() for lib in IK.LIBS]
    with pytest.raises(ValueError):
        IK.step_lookup_cuda(qt.long(), kt, pt[:-1], pt[1:])
    with pytest.raises(ValueError):
        IK.step_lookup_cuda(qt, kt, pt[:-1].cpu(), pt[1:])
    big = torch.arange(5000, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        IK.step_lookup_cuda(qt, big, big, big)
    with pytest.raises(ValueError):
        IK.segmented_step_lookup_cuda(qt, kt, pt[:-1], pt[1:-1])
    assert [lib.launches() for lib in IK.LIBS] == before


ATTN_TOL = {torch.float32: (3e-5, 1e-5, 1e-5, 2e-5),
            torch.bfloat16: (2e-2, 2e-2, 2e-2, 2e-2)}


def _randn(card, seed, *shapes, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dtype)
            for s in shapes]


@pytest.mark.parametrize("Hq,Hkv,D", [(40, 8, 128), (32, 2, 64), (8, 8, 128),
                                      (8, 4, 32)])
@pytest.mark.parametrize("S", [1, 127, 4096, 20000])     # unsplit and split
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain_version(card, Hq, Hkv, D, S,
                                                      dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    B = 3
    R, G = B * Hkv, Hq // Hkv
    q, k, v = _randn(card, Hq + S + D, (R, G, D), (R, S, D), (R, S, D),
                     dtype=dtype)
    lens = np.random.default_rng(S).integers(1, S + 1, B)
    lens[0] = 0
    lt = torch.from_numpy(np.repeat(lens, Hkv).astype(np.int32)).to(card)
    before = DK.launches()
    o, m, l = DK.decode_attention_cuda(q, k, v, lt)
    torch.cuda.synchronize()
    assert DK.launches() == before + 1
    po, pm, pl = da.decode_attention_ref(q, k, v, lt)
    to, tm, tl, _ = ATTN_TOL[dtype]
    assert float((o - po).abs().max()) <= to
    assert float((m - pm).abs().max()) <= tm
    assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= tl
    assert torch.all(o[:Hkv] == 0) and torch.all(l[:Hkv] == 0)


@pytest.mark.parametrize("case", [
    dict(B=2, Hq=4, Hkv=2, Sq=96, Skv=96, D=64),
    dict(B=1, Hq=4, Hkv=4, Sq=100, Skv=228, D=32, window=50),
    dict(B=1, Hq=2, Hkv=1, Sq=128, Skv=128, D=128, window=64, softcap=50.0),
    dict(B=1, Hq=40, Hkv=8, Sq=1000, Skv=1500, D=128),
    dict(B=2, Hq=8, Hkv=8, Sq=1, Skv=300, D=128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain_version(card, case, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dict(case)
    B, Hq, Hkv, Sq, Skv, D = (c.pop(x) for x in ("B", "Hq", "Hkv", "Sq",
                                                 "Skv", "D"))
    q, k, v = _randn(card, Sq + Skv, (B, Hq, Sq, D), (B, Hkv, Skv, D),
                     (B, Hkv, Skv, D), dtype=dtype)
    before = AK.launches()
    o = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert AK.launches() == before + 1 and o.dtype == dtype
    want = fa.attention_ref(q, k, v, **c)
    assert float((o.float() - want).abs().max()) <= ATTN_TOL[dtype][3]


def test_flash_attention_kernel_writes_through_strides(card):
    B, S, Hq, Hkv, D = 2, 300, 8, 2, 128
    q, k, v = _randn(card, 1, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                     dtype=torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty(B, S, Hq, D, dtype=torch.bfloat16, device=card)
    AK.flash_attention_cuda(q, k, v, out=out.transpose(1, 2))
    want = AK.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out.transpose(1, 2), want)


def test_attention_kernels_reject_what_they_do_not_take(card):
    q = torch.zeros(4, 20, 64, device=card)
    k = torch.zeros(4, 64, 64, device=card)
    lens = torch.ones(4, dtype=torch.int32, device=card)
    before = (DK.launches(), AK.launches())
    with pytest.raises(ValueError):                     # no query rows
        DK.decode_attention_cuda(q[:, :0], k, k, lens)
    with pytest.raises(ValueError):                     # head dim 96
        DK.decode_attention_cuda(q.new_zeros(4, 20, 96), k.new_zeros(
            4, 64, 96), k.new_zeros(4, 64, 96), lens)
    with pytest.raises(ValueError):
        DK.decode_attention_cuda(q[:, :4], k, k, lens.long())
    with pytest.raises(ValueError):
        AK.flash_attention_cuda(torch.zeros(1, 2, 8, 96, device=card),
                                torch.zeros(1, 2, 8, 96, device=card),
                                torch.zeros(1, 2, 8, 96, device=card))
    assert (DK.launches(), AK.launches()) == before


# the bf16 kernels' tile edges: 128-query (64 a warpgroup) and 96-key
# flash tiles, 64-key decode tiles of four 16-key warp slices
FLASH_EDGE_SQ = (1, 63, 64, 65, 95, 96, 97, 127, 128, 129, 191, 192, 193,
                 255)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("extra", [0, 1, 200])
@pytest.mark.parametrize("Sq", FLASH_EDGE_SQ)
def test_flash_bf16_kernel_at_tile_edges(card, Sq, extra, D):
    B, Hq, Hkv, Skv = 2, 4, 2, Sq + extra
    q, k, v = _randn(card, Sq * 1000 + extra * 10 + D, (B, Hq, Sq, D),
                     (B, Hkv, Skv, D), (B, Hkv, Skv, D), dtype=torch.bfloat16)
    o = AK.flash_attention_cuda(q, k, v)
    want = fa.attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert float((o.float() - want).abs().max()) <= ATTN_TOL[torch.bfloat16][3]


@pytest.mark.parametrize("case", [
    dict(B=1, Hq=4, Hkv=2, Sq=1000, Skv=1000, D=128, window=300,
         softcap=30.0),
    dict(B=2, Hq=4, Hkv=4, Sq=1000, Skv=1000, D=64, window=129,
         softcap=50.0),
    dict(B=1, Hq=40, Hkv=8, Sq=4096, Skv=4096, D=128),
])
def test_flash_bf16_kernel_window_softcap_and_qwen3_heads(card, case):
    c = dict(case)
    B, Hq, Hkv, Sq, Skv, D = (c.pop(x) for x in ("B", "Hq", "Hkv", "Sq",
                                                 "Skv", "D"))
    q, k, v = _randn(card, Sq + D, (B, Hq, Sq, D), (B, Hkv, Skv, D),
                     (B, Hkv, Skv, D), dtype=torch.bfloat16)
    o = AK.flash_attention_cuda(q, k, v, **c)
    want = fa.attention_ref(q, k, v, **c)
    torch.cuda.synchronize()
    assert float((o.float() - want).abs().max()) <= ATTN_TOL[torch.bfloat16][3]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 5, 8, 16])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 4096, 32768])
def test_decode_bf16_kernel_groups_and_tile_edges(card, S, group, D):
    B, Hkv = 4, 2
    R = B * Hkv
    q, k, v = _randn(card, S + group * 7 + D, (R, group, D), (R, S, D),
                     (R, S, D), dtype=torch.bfloat16)
    lens = np.random.default_rng(S + group).integers(1, S + 1, B)
    lens[1] = 0                                   # one row of length 0
    lens[2] = S                                   # one row at capacity
    lt = torch.from_numpy(np.repeat(lens, Hkv).astype(np.int32)).to(card)
    o, m, l = DK.decode_attention_cuda(q, k, v, lt)
    po, pm, pl = da.decode_attention_ref(q, k, v, lt)
    torch.cuda.synchronize()
    to, tm, tl, _ = ATTN_TOL[torch.bfloat16]
    assert float((o - po).abs().max()) <= to
    assert float((m - pm).abs().max()) <= tm
    assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= tl
    dead = slice(Hkv, 2 * Hkv)
    assert torch.all(o[dead] == 0) and torch.all(l[dead] == 0) \
        and torch.all(m[dead] == -1e30)


@pytest.mark.parametrize("rows", [17, 20, 32, 64, 65, 70, 128])
@pytest.mark.parametrize("S", [63, 4096])           # unsplit and split
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_many_query_rows(card, rows, S, dtype):
    """Several new tokens a step fold into group·Sq query rows: the
    kernel at rows around its 16-row m-tiles and 64-row tiles (one
    launch whatever the tiles), with a row of length 0 and one at S."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hkv, D = 3, 2, 128
    R = B * Hkv
    q, k, v = _randn(card, rows * 31 + S, (R, rows, D), (R, S, D),
                     (R, S, D), dtype=dtype)
    lens = np.random.default_rng(rows + S).integers(1, S + 1, B)
    lens[0], lens[1] = 0, S
    lt = torch.from_numpy(np.repeat(lens, Hkv).astype(np.int32)).to(card)
    before = DK.launches()
    o, m, l = DK.decode_attention_cuda(q, k, v, lt)
    torch.cuda.synchronize()
    assert DK.launches() == before + 1
    po, pm, pl = da.decode_attention_ref(q, k, v, lt)
    to, tm, tl, _ = ATTN_TOL[dtype]
    assert float((o - po).abs().max()) <= to
    assert float((m - pm).abs().max()) <= tm
    assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= tl
    assert torch.all(o[:Hkv] == 0) and torch.all(l[:Hkv] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_are_deterministic_and_count_one_launch(card,
                                                                  dtype):
    """Two calls on the same inputs are bitwise equal (no atomics), and
    each call counts exactly one launch, split or not."""
    q, k, v = _randn(card, 7, (1, 8, 700, 128), (1, 2, 900, 128),
                     (1, 2, 900, 128), dtype=dtype)
    before = AK.launches()
    a = AK.flash_attention_cuda(q, k, v, window=500)
    assert AK.launches() == before + 1
    b = AK.flash_attention_cuda(q, k, v, window=500)
    torch.cuda.synchronize()
    assert AK.launches() == before + 2 and torch.equal(a, b)
    for S in (40, 20000):                        # unsplit, split
        dq, dk, dv = _randn(card, S, (6, 5, 128), (6, S, 128), (6, S, 128),
                            dtype=dtype)
        lt = torch.full((6,), S - 3, dtype=torch.int32, device=card)
        before = DK.launches()
        first = DK.decode_attention_cuda(dq, dk, dv, lt)
        assert DK.launches() == before + 1
        second = DK.decode_attention_cuda(dq, dk, dv, lt)
        torch.cuda.synchronize()
        assert DK.launches() == before + 2
        assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_shared_memory_mirrors_equal_the_sources(card):
    """The wrappers' shared-memory arithmetic equals what each kernel
    source asks for, instantiation by instantiation."""
    import ctypes
    dlib = ctypes.CDLL(str(DK.build()))
    flib = ctypes.CDLL(str(AK.build()))
    bits = {torch.float32: 0, torch.bfloat16: 1}
    for D in (32, 64, 128):
        for dt in bits:
            assert flib.flash_attention_smem_bytes(D, bits[dt]) \
                == AK.smem_bytes(D, dt)
            for kt in bits:
                assert dlib.decode_attention_smem_bytes(
                    D, bits[dt], bits[kt]) == DK.smem_bytes(D, dt, kt)
    assert flib.flash_attention_smem_bytes(96, 1) == -1


# ---------------------------------------------------------------------------
# the redesigned candidate_score and fused_descent, windowed decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C", [1, 39, 300])
@pytest.mark.parametrize("S", [65536, 65537, 65538, 65539, 5, 6, 7, 8])
def test_candidate_score_split_rows_at_every_alignment(card, C, S):
    """S % 4 in {0, 1, 2, 3}, so rows start at every 16-byte offset; two
    launches are bit-equal and leave the ticket counters at 0."""
    rng = np.random.default_rng(C * 7 + S)
    W = rng.uniform(16.0, 1e6, size=(C, S))
    wt = rng.uniform(0.5, 4.0, size=S)
    ell, inv_bw = affine_coefficients(PROFILES["azure_ssd"])
    Wt = torch.from_numpy(W.astype(np.float32)).to(card)
    wtt = torch.from_numpy(wt.astype(np.float32)).to(card)
    first = CK.affine_scores_cuda(Wt, wtt, ell, inv_bw)
    second = CK.affine_scores_cuda(Wt, wtt, ell, inv_bw)
    plain = cs.affine_scores_torch(Wt, wtt, ell, inv_bw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert int(CK._tickets(card, C)[:C].abs().sum()) == 0
    np.testing.assert_allclose(first.cpu().numpy(), plain.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(first.cpu().numpy().astype(np.float64),
                               cs.affine_scores_ref(W, wt, ell, inv_bw),
                               rtol=3e-5)


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("P", [128, 640, 4096])
def test_fused_descent_layers_in_parallel(card, L, P):
    """Mixed planes of 1-4 layers, every layer on its own blocks: the
    kernel equals the plain version bit for bit, and the engine's staged
    path (pinned buffers, one copy each way) returns the same windows."""
    rng = np.random.default_rng(L * 1000 + P + 1)
    layers = _prefix(rng, L, P, True)
    mod = fd.FusedDescent(fd.pack_prefix(layers), device=card)
    for Q in (1, 127, 4097, 300):           # the buffers grow, then shrink
        q = rng.integers(1, 2**31 - 2, Q).astype(np.uint64)
        qt = torch.from_numpy(q.astype(np.int32)).to(card)
        lo, hi = mod(qt)
        plo, phi = fd.fused_descent_torch(mod.planes(), qt)
        torch.cuda.synchronize()
        assert torch.equal(lo, plo) and torch.equal(hi, phi)
        before = K.launches()
        slo, shi, used = fd.fused_descent_with_backend(layers, q,
                                                       module=mod)
        assert used == "cuda" and K.launches() == before + 1
        np.testing.assert_array_equal(slo, plo.cpu().numpy())
        np.testing.assert_array_equal(shi, phi.cpu().numpy())
        assert slo.dtype == np.float64 and slo.shape == (L, Q)


@pytest.mark.parametrize("window", [1, 63, 64, 65, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 64, 4095, 4097, 32768])
def test_decode_window_and_softcap_at_tile_and_window_edges(card, S, dtype,
                                                            window):
    """gemma2's heads (32 query, 16 kv, D = 128), with row lengths at 0,
    1, the window's edges and the capacity; a softcap of 5 bends scores of
    the inputs' size (gemma2's 50 is held in chip_smoke.py phase 10)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hkv, G, D = 4, 16, 2, 128
    R = B * Hkv
    q, k, v = _randn(card, S + window, (R, G, D), (R, S, D), (R, S, D),
                     dtype=dtype)
    q = q * 2
    lens = np.asarray([0, 1, min(window + 1, S), S])
    lt = torch.from_numpy(np.repeat(lens, Hkv).astype(np.int32)).to(card)
    o, m, l = DK.decode_attention_cuda(q, k, v, lt, window=window,
                                       softcap=5.0)
    po, pm, pl = da.decode_attention_ref(q, k, v, lt, window=window,
                                         softcap=5.0)
    torch.cuda.synchronize()
    to, tm, tl, _ = ATTN_TOL[dtype]
    assert float((o - po).abs().max()) <= to
    assert float((m - pm).abs().max()) <= tm
    assert float(((l - pl).abs() / pl.clamp_min(1.0)).max()) <= tl
    assert torch.all(o[:Hkv] == 0) and torch.all(l[:Hkv] == 0)


def test_fused_descent_staging_is_shared_safely_across_threads(card):
    """The engine descends from its serving thread and its prefetch
    worker at once, through one module's staging buffers: eight threads
    of mixed batch sizes, a short switch interval, each result equal to
    its own batch's plain version."""
    import sys
    import threading
    rng = np.random.default_rng(5)
    layers = _prefix(rng, 2, 640, True)
    mod = fd.FusedDescent(fd.pack_prefix(layers), device=card)
    batches = [rng.integers(1, 2**31 - 2, int(n)).astype(np.uint64)
               for n in rng.integers(1, 5000, 64)]
    want = []
    for q in batches:
        lo, hi = fd.fused_descent_torch(
            mod.planes(), torch.from_numpy(q.astype(np.int32)).to(card))
        want.append((lo.cpu().numpy(), hi.cpu().numpy()))
    bad = []

    def work(k):
        for i in range(k, len(batches), 8):
            lo, hi = mod.descend(batches[i])
            if not (np.array_equal(lo, want[i][0])
                    and np.array_equal(hi, want[i][1])):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not bad


# ---------------------------------------------------------------------------
# the redesigned band and segmented-step kernels
# ---------------------------------------------------------------------------
I32_MAX = 2**31 - 1
EDGE_Q = [1, 31, 32, 33, 4097, 1 << 20]


def _edge_queries(rng, keys, Q):
    """Q queries: random, then (as far as Q holds them) below the first
    key, the last key, above it, 2^31 − 1 and every grid key."""
    q = rng.integers(1, 2**31 - 2, Q).astype(np.int32)
    edges = np.concatenate([[0, keys[-1], keys[-1] + 1, I32_MAX],
                            keys[::il.LANE]]).astype(np.int32)
    n = min(Q, len(edges))
    q[:n] = edges[:n]
    return q


def _one_launch(lib, fn):
    before = lib.launches()
    out = fn()
    torch.cuda.synchronize()
    assert lib.launches() == before + 1
    return out


@pytest.mark.parametrize("P", [1, 171, 723, 4096])
@pytest.mark.parametrize("Q", EDGE_Q)
def test_band_kernel_bit_equal_at_edges(card, P, Q):
    rng = np.random.default_rng(P * 7 + Q)
    arrays = _layer(rng, P, True)
    ts = _on(card, _edge_queries(rng, arrays[0], Q), *arrays)
    lo, hi = _one_launch(IK.BAND, lambda: il.lookup_band_layer(*ts))
    plo, phi = il.band_lookup_torch(*ts)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


@pytest.mark.parametrize("P", [4097, 4224, 4225, 20_000, 81_298])
@pytest.mark.parametrize("Q", EDGE_Q)
def test_segmented_kernel_bit_equal_at_edges(card, P, Q):
    rng = np.random.default_rng(P * 5 + Q)
    keys, pos = _layer(rng, P, False)
    qt, kt, pt = _on(card, _edge_queries(rng, keys, Q), keys, pos)
    lo, hi = _one_launch(IK.SEGMENTED,
                         lambda: il.lookup_step_layer(qt, kt, pt))
    plo, phi = il.segmented_step_lookup_torch(
        qt, il.segment_bases(kt, qt), kt, pt[:-1], pt[1:])
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


@pytest.mark.parametrize("over", [0, 1])
def test_segmented_grid_across_the_shared_memory_cap(card, over):
    """At the cap the block stages the whole grid; one entry past it the
    kernel searches the grid in global memory.  Both equal the plain
    two-level version."""
    P = IK.grid_cap() * il.LANE + over
    rng = np.random.default_rng(over)
    keys = (1 + np.concatenate([[0], np.cumsum(rng.integers(
        1, (2**31 - 2) // P, P - 1))])).astype(np.int32)
    pos = np.sort(rng.integers(0, 2**30, P + 1)).astype(np.int32)
    qt, kt, pt = _on(card, _edge_queries(rng, keys, 70_000), keys, pos)
    lo, hi = _one_launch(IK.SEGMENTED,
                         lambda: il.lookup_step_layer(qt, kt, pt))
    plo, phi = il.segmented_step_lookup_torch(
        qt, il.segment_bases(kt, qt), kt, pt[:-1], pt[1:])
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


# ---------------------------------------------------------------------------
# the sharded fleet served on the card
# ---------------------------------------------------------------------------
def test_fleet_on_the_card_equals_the_numpy_backend(card, tmp_path):
    """Four int32-domain shards of 3-layer demo designs (the root resident
    and packed for the card, the rest walked on disk), served on the card:
    one ``fused_descent`` launch a non-empty shard sub-batch, ranges equal
    to the numpy backend's bit for bit."""
    from repro_torch.api import ServeSpec
    from repro_torch.core import KeyPositions, write_index
    from repro_torch.fleet import FleetService, ShardMap
    from repro_torch.fleet.fleet import _partition
    from repro_torch.serve import demo_serving_design
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(1, 2**31 - 2, 60_000)).astype(np.uint64)
    D = KeyPositions.fixed_record(keys, 16)
    shard_map = ShardMap.even_keys(D.keys, 4)
    parts, bases = _partition(D, shard_map)
    paths = []
    for i, part in enumerate(parts):
        paths.append(str(tmp_path / f"shard_{i}.air"))
        write_index(paths[-1], demo_serving_design(part), page_bytes=1024)
    batches = np.split(rng.choice(keys, 2048), 4)
    subs = sum(len(shard_map.sub_batches(b)) for b in batches)

    def serve(backend):
        return FleetService(shard_map, paths, bases, specs=[
            ServeSpec(backend=backend, cache_bytes=(16 << 10,))] * 4)
    before = K.launches()
    with serve("cuda") as svc:
        got = svc.lookup_batches(batches)
        assert all(s.device.type == "cuda" and s.device_active
                   for s in svc.services)
        assert all(s.stats.device_batches == s.stats.batches
                   for s in svc.services)
    assert K.launches() - before == subs
    with serve("numpy") as svc:
        want = svc.lookup_batches(batches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# training: attention's gradient and a step on the card
# ---------------------------------------------------------------------------
def _attention_grads_vs_plain(card, dtype, B, Hq, Hkv, S, D, **opts):
    """``FlashAttention`` against the plain version in float32: its output
    (the kernel's forward) within the flash limit, asserted here, and its
    dq, dk, dv (the PyTorch backward, which recomputes the output itself)
    against autograd through the plain version → the worst gradient error
    over max |grad| (absolute for a gradient that is 0), and the kernel's
    launches."""
    from repro_torch.models.layers import FlashAttention
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _randn(card, S * 7 + D, (B, S, Hq, D), (B, S, Hkv, D),
                         (B, S, Hkv, D), (B, Hq, S, D), dtype=dtype)
    q, k, v = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    before = AK.launches()
    out = FlashAttention.apply(q, k, v, True, opts.get("window"),
                               opts.get("softcap"), None)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    launches = AK.launches() - before
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_out = fa.attention_ref(*ref_in, **opts)
    assert out.dtype == dtype and out.shape == q.shape
    assert float((out.detach().float() - ref_out.detach()).abs().max()) \
        <= ATTN_TOL[dtype][3]
    want = torch.autograd.grad(ref_out, ref_in, do.float())
    # over max |grad|, or absolute where the gradient is 0 (dq at S = 1)
    err = max(float((g.float() - w).abs().max()
                    / (w.abs().max() if w.abs().max() > 0 else 1.0))
              for g, w in zip(got, want))
    assert all(g.dtype == dtype and g.shape == x.shape
               for g, x in zip(got, (q, k, v)))
    return err, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_at_the_training_shape(card, dtype):
    err, launches = _attention_grads_vs_plain(card, dtype, 4, 40, 8, 512,
                                              128)
    assert launches == 1                  # the backward launches nothing
    assert err <= ATTN_TOL[dtype][3], err


@pytest.mark.parametrize("opts", [{}, dict(window=100, softcap=30.0)],
                         ids=["causal", "window-softcap"])
@pytest.mark.parametrize("S", [1, 127, 128, 513])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_at_the_kernels_tile_edges(card, dtype, S, opts):
    err, launches = _attention_grads_vs_plain(card, dtype, 2, 4, 2, S, 64,
                                              **opts)
    assert launches == 1
    assert err <= ATTN_TOL[dtype][3], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_training_step_on_the_card_equals_the_cpus(card, dtype,
                                                     monkeypatch):
    """One SMOKE qwen3 step from the same parameters and batch: loss and
    gradient norm within the flash kernel's limit (float32 2e-5, relative
    here; bfloat16 2e-2), parameters within rtol 1e-5 / atol 1e-6 in
    float32 (tests/test_torch_train.py's, for the same reasons); exactly
    two flash launches a layer (the forward and the remat recompute) and
    no plain attention on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.convert import load_params_, params_tree
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import TrainConfig, adamw_init, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-14b", smoke=True).scaled(dtype=dtype)
    cpu = api.init_params(
        cfg, torch.Generator().manual_seed(4), "cpu")
    gpu = Transformer(cfg, card)
    load_params_(cfg, gpu, params_tree(cfg, cpu))
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    out = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        model.requires_grad_(True)
        tcfg = TrainConfig()
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        before = AK.launches()
        _, _, m = make_train_step(cfg, tcfg)(
            model, opt, {k: v.to(model.device) for k, v in batch.items()})
        loss, gnorm = torch.stack([m["loss"], m["grad_norm"]]).tolist()
        out[name] = (loss, gnorm, AK.launches() - before,
                     params_tree(cfg, model))
        if name == "cpu":
            monkeypatch.setattr(fa.ops.ref, "attention_ref", None)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert out["cuda"][2] == 2 * cfg.n_layers and out["cpu"][2] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=tol)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=tol)
    if dtype == "float32":
        got, want = out["cuda"][3], out["cpu"][3]
        for key in ("embed", "unembed", "final_norm"):
            torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                       atol=1e-6)
        for key, w in want["blocks"].items():
            torch.testing.assert_close(got["blocks"][key], w, rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the other families: non-causal Sq > Skv, and each family on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Skv", [(448, 32), (4096, 1500), (129, 95),
                                    (300, 1), (1, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_noncausal_with_more_queries_than_keys(card, Sq, Skv,
                                                            dtype):
    """Whisper's cross-attention: every query sees every key, also when
    the decoder is longer than the encoder (the kernel's key range does
    not read the negative query offset without a causal mask or
    window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, D = 2, 12, 64
    q, k, v = _randn(card, Sq + Skv, (B, H, Sq, D), (B, H, Skv, D),
                     (B, H, Skv, D), dtype=dtype)
    before = AK.launches()
    o = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert AK.launches() == before + 1 and o.dtype == dtype
    want = fa.attention_ref(q, k, v, causal=False)
    assert float((o.float() - want).abs().max()) <= ATTN_TOL[dtype][3]
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q.new_zeros((B, H, 2, D)), k[:, :, :1],
                           v[:, :, :1])


FAMILY_ARCHS = ["llama4_scout_17b_a16e", "grok1_314b", "llava_next_34b",
                "zamba2_1p2b", "rwkv6_7b", "whisper_small"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_family_forward_and_decode_on_the_card_equal_the_cpus(card, arch,
                                                                dtype):
    """One SMOKE forward and two decode steps of each new family on the
    card (through the attention kernels, none plain) against the CPU's
    (the plain versions) from the same parameters: logits within 1e-4 of
    max |logit| in float32 (the flash limit through two layers), 3e-2 in
    bfloat16 (tests/test_torch_models.py's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.convert import load_params_, params_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True).scaled(dtype=dtype)
    cpu = api.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu")
    gpu = api.empty_params(cfg, card)
    load_params_(cfg, gpu, params_tree(cfg, cpu))
    rng = np.random.default_rng(8)
    B, S = 2, 40                         # S past whisper SMOKE's 32 frames
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)).to(
                cfg.torch_dtype)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.05).to(
                cfg.torch_dtype)
        batch["patch_positions"] = torch.from_numpy(np.stack(
            [rng.choice(S, cfg.n_patches, replace=False) for _ in range(B)])
            .astype(np.int32))
    out = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = model.device
        before = (AK.launches(), DK.launches())
        with torch.no_grad():
            logits, _ = api.forward_train(
                cfg, model, {k: v.to(dev) for k, v in batch.items()})
            frames = batch["frames"].to(dev) if "frames" in batch else None
            state = api.init_decode_state(cfg, model, B, 8, frames=frames)
            steps = []
            for t in range(2):
                d, state = api.forward_decode(
                    cfg, model, {"tokens": batch["tokens"][:, t:t + 1]
                                 .to(dev)}, state, t)
                steps.append(d.float().cpu())
        out[name] = (logits.float().cpu(), steps,
                     (AK.launches() - before[0], DK.launches() - before[1]))
    tol = 1e-4 if dtype == "float32" else 3e-2
    want, got = out["cpu"], out["cuda"]
    for g, w in zip([got[0], *got[1]], [want[0], *want[1]]):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) / scale < tol
    assert want[2] == (0, 0)
    uses_attention = cfg.family != "ssm"
    assert (got[2][0] > 0) == uses_attention
    assert (got[2][1] > 0) == uses_attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_sharded_decode_on_one_card(card, dtype):
    """Four contiguous sequence shards, each through the decode kernel,
    combined by ``combine_partials``, against the unsharded kernel and
    the plain version: lengths S, S − 17, 300 (two shards empty) and 1
    (three empty); an empty shard's partial is m = −1e30, l = 0.  The
    error is taken relative to max |plain| (over a long cache |o| is far
    below 1): float32 at the decode limit (3e-5), bfloat16 at 2e-2."""
    from repro_torch.serve import attention as SA
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, Hkv, S, D, N = 2, 8, 2, 1024, 128, 4
    rng = np.random.default_rng(31)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    q, k, v = randn(B, Hq, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    qc, kc, vc = (t.to(card, dt) for t in (q, k, v))
    Sl = S // N
    shards = [(kc[:, :, i * Sl:(i + 1) * Sl].contiguous(),
               vc[:, :, i * Sl:(i + 1) * Sl].contiguous()) for i in range(N)]
    tol = 3e-5 if dtype == "float32" else 2e-2
    for L in (S, S - 17, 300, 1):
        lengths = torch.full((B,), L, dtype=torch.int32)
        lc = lengths.to(card)
        before = DK.launches()
        parts = [da.decode_attention(qc, ck, cv, SA.shard_lengths(lc, i, Sl))
                 for i, (ck, cv) in enumerate(shards)]
        torch.cuda.synchronize()
        assert DK.launches() == before + N
        o, m, l = (torch.stack(t) for t in zip(*parts))
        got = da.combine_partials(o, m, l)[0].cpu()
        whole = da.decode_attention(qc, kc, vc, lc)[0].cpu()
        plain = da.decode_attention(qc.cpu().float(), kc.cpu().float(),
                                    vc.cpu().float(), lengths)[0]
        top = float(plain.abs().max())
        assert float((got - whole).abs().max()) / top < tol, L
        assert float((got - plain).abs().max()) / top < tol, L
        for i in range(N):
            if i * Sl >= L:
                assert bool((m[i] == -1e30).all()) and bool((l[i] == 0).all())


def test_error_state_of_specs_lands_on_the_card(card):
    """``init_error_state`` of spec leaves, no device named, gives zeros
    on the card, where ``compressed_psum`` under NCCL needs them."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train import compression as TC
    specs = api.param_specs(get_config("qwen3-14b", smoke=True))
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    err = TC.init_error_state(specs)
    walk(err)
    assert leaves and all(t.device.type == "cuda" and not bool(t.any())
                          for t in leaves)


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b",
                                  "whisper-small"])
def test_the_seeded_draw_on_the_card_equals_the_cpus(card, arch):
    """``init_params(cfg, 0)`` (the JAX package's draw) gives the same
    bits on the card as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(arch, smoke=True)
    gpu = api.init_params(cfg, 0, card)
    cpu = api.init_params(cfg, 0, "cpu")
    for (name, a), (_, b) in zip(gpu.named_parameters(),
                                 cpu.named_parameters()):
        assert torch.equal(a.cpu(), b), name
