"""The port's attention plain versions against the JAX package's kernels,
run as the JAX package's own tests run them on the CPU (Pallas in
interpret mode), and against its jnp oracles, on the same numpy-seeded
inputs.

Tolerances: float32 at the JAX kernel tests' own limits (flash 2e-5;
decode 3e-5 on o and 1e-5 on m, the normalizer l relative 1e-5) — the
sums run in another order; bfloat16 flash at 2e-2, the JAX test's limit
for a bf16 output.  The kernels themselves are held against these plain
versions on the card (``test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as jdk
from repro.kernels.decode_attention import ops as jdo
from repro.kernels.decode_attention import ref as jdr
from repro.kernels.flash_attention import ops as jfo
from repro.kernels.flash_attention import ref as jfr
from repro.models.transformer import decode_attention_jnp
from repro_torch.kernels import _meta
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.flash_attention import kernel as AK

F32 = {"o": 3e-5, "m": 1e-5, "l": 1e-5}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _close(port, ref, tol=F32):
    o, m, l = (np.asarray(x, np.float32) for x in ref)
    po, pm, pl = (x.numpy() for x in port)
    assert np.abs(po - o).max() < tol["o"]
    assert np.abs(pm - m).max() < tol["m"]
    assert (np.abs(pl - l) / np.maximum(l, 1.0)).max() < tol["l"]


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Hkv,S,D,partial", [
    (2, 4, 4, 256, 64, False), (2, 8, 2, 256, 64, False),
    (3, 8, 4, 192, 32, True), (1, 16, 8, 128, 128, True),
])
def test_decode_plain_matches_pallas_and_ref(B, Hq, Hkv, S, D, partial):
    rng = np.random.default_rng(B * 1000 + Hq * 10 + D)
    q = rng.normal(size=(B, Hq, D))
    k = rng.normal(size=(B, Hkv, S, D))
    v = rng.normal(size=(B, Hkv, S, D))
    L = rng.integers(1, S + 1, B).astype(np.int32) if partial else None
    jL = None if L is None else jnp.asarray(L)
    pallas = jdo.decode_attention(jnp.asarray(q, jnp.float32),
                                  jnp.asarray(k, jnp.float32),
                                  jnp.asarray(v, jnp.float32), jL,
                                  block_k=64)
    oracle = jdr.decode_attention_ref(jnp.asarray(q, jnp.float32),
                                      jnp.asarray(k, jnp.float32),
                                      jnp.asarray(v, jnp.float32), jL)
    port = da.decode_attention(_t(q), _t(k), _t(v),
                               None if L is None else torch.from_numpy(L))
    assert all(x.dtype == torch.float32 for x in port)
    assert port[0].shape == (B, Hq, D) and port[1].shape == (B, Hq)
    _close(port, pallas)
    _close(port, oracle)


def test_decode_length_zero_row_follows_the_tpu_kernel():
    """A row of length 0: the Pallas kernel skips every block (o = 0,
    m = −1e30, l = 0) and so does the port; the JAX oracle masks every
    score instead (l = S, o = mean(v)).  Either row weighs 0 when shards
    are combined."""
    B, Hq, Hkv, S, D = 3, 8, 2, 128, 64
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s) for s in ((B, Hq, D), (B, Hkv, S, D),
                                             (B, Hkv, S, D)))
    L = np.asarray([0, 77, 128], np.int32)
    jq, jk, jv = (jnp.asarray(x, jnp.float32) for x in (q, k, v))
    pallas = jdo.decode_attention(jq, jk, jv, jnp.asarray(L), block_k=64)
    oracle = jdr.decode_attention_ref(jq, jk, jv, jnp.asarray(L))
    port = da.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(L))
    _close(port, pallas)
    o, m, l = (x.numpy() for x in port)
    assert np.all(o[0] == 0) and np.all(m[0] == np.float32(-1e30)) \
        and np.all(l[0] == 0)
    # the oracle's row 0 differs exactly there, and only there
    ro, rm, rl = (np.asarray(x) for x in oracle)
    np.testing.assert_allclose(rl[0], S)
    np.testing.assert_allclose(
        ro[0], np.repeat(v[0].mean(axis=1), Hq // Hkv, axis=0), atol=3e-5)
    _close(tuple(x[1:] for x in port), tuple(x[1:] for x in oracle))


def test_decode_folded_plain_matches_the_pallas_kernel_directly():
    """The folded layout the hand-written kernel takes, against
    ``decode_attention_pallas`` (interpret) on the same rows."""
    R, G, S, D = 6, 5, 256, 128
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=s) for s in ((R, G, D), (R, S, D),
                                             (R, S, D)))
    L = np.asarray([1, 0, 64, 65, 200, 256], np.int32)
    pallas = jdk.decode_attention_pallas(
        jnp.asarray(q, jnp.float32), jnp.asarray(k[:, None], jnp.float32),
        jnp.asarray(v[:, None], jnp.float32), jnp.asarray(L), block_k=64,
        interpret=True)
    port = da.decode_attention_folded(_t(q), _t(k), _t(v),
                                      torch.from_numpy(L))
    _close(port, pallas)


@pytest.mark.parametrize("window", [None, 1, 16, 100, 300])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_window_and_softcap_match_the_jax_models_decode(window,
                                                               softcap):
    """The JAX model's decode attention (``decode_attention_jnp``: the
    softcap on the scaled scores, then the mask ``k_pos > kv_len − 1 −
    window``) against the plain version, with lengths below, at and above
    the window; m and l against a float64 numpy softmax over the same live
    keys."""
    B, Hq, Hkv, S, D = 4, 8, 2, 256, 32
    rng = np.random.default_rng(17 + (window or 0))
    q = rng.normal(size=(B, Hq, D)) * 2.0      # scores past the softcap
    k, v = (rng.normal(size=(B, Hkv, S, D)) for _ in range(2))
    L = np.asarray([1, 15, 101, 256], np.int32)
    want = decode_attention_jnp(
        jnp.asarray(q[:, :, None], jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(L), window=window,
        softcap=softcap)
    o, m, l = da.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(L),
                                  window=window, softcap=softcap)
    np.testing.assert_allclose(o.numpy(), np.asarray(want)[:, :, 0],
                               atol=F32["o"], rtol=0)
    G = Hq // Hkv
    s = np.einsum("bhd,bhsd->bhs", q / np.sqrt(D),
                  np.repeat(k, G, axis=1))
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    pos = np.arange(S)[None, None, :]
    live = pos < L[:, None, None]
    if window is not None:
        live &= pos > L[:, None, None] - 1 - window
    mx = np.where(live, s, -np.inf).max(axis=-1)
    lsum = np.where(live, np.exp(s - mx[..., None]), 0.0).sum(axis=-1)
    np.testing.assert_allclose(m.numpy(), mx, atol=F32["m"], rtol=0)
    np.testing.assert_allclose(l.numpy(), lsum, rtol=F32["l"])


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_combine_partials_over_four_shards_equals_full(kv_dtype):
    B, Hq, Hkv, S, D = 2, 8, 2, 256, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=s) for s in ((B, Hq, D), (B, Hkv, S, D),
                                             (B, Hkv, S, D)))
    tq, tk, tv = _t(q), _t(k, kv_dtype), _t(v, kv_dtype)
    full = da.decode_attention(tq, tk, tv)
    parts = [da.decode_attention(tq, tk[:, :, i * 64:(i + 1) * 64],
                                 tv[:, :, i * 64:(i + 1) * 64])
             for i in range(4)]
    O, M, L = da.combine_partials(*(torch.stack([p[j] for p in parts])
                                    for j in range(3)))
    _close((O, M, L), full)
    # the JAX package's combination of the same partials
    jO, jM, jL = jdo.combine_partials(*(jnp.asarray(torch.stack(
        [p[j] for p in parts]).numpy()) for j in range(3)))
    _close((O, M, L), (jO, jM, jL))
    if kv_dtype == torch.float32:
        oracle = jdr.decode_attention_ref(*(jnp.asarray(x, jnp.float32)
                                            for x in (q, k, v)))
        _close((O, M, L), oracle)


def test_decode_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, k = torch.zeros(2, 4, 64), torch.zeros(2, 128, 64)
    lens = torch.full((2,), 128, dtype=torch.int32)
    before = DK.launches()
    da.decode_attention_folded(q, k, k, lens)      # the plain version
    with pytest.raises(ValueError, match="CUDA tensor"):
        DK.decode_attention_cuda(q, k, k, lens)
    booked = []                                     # a meta trace's branch
    with _meta.recording(booked):
        o, _, _ = da.decode_attention_folded(q.to("meta"), k.to("meta"),
                                             k.to("meta"), lens.to("meta"))
    assert o.device.type == "meta" and len(booked) == 1
    assert DK.launches() == before


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
ATTN_CASES = [          # tests/test_kernels.py's
    dict(B=2, Hq=4, Hkv=4, Sq=128, Skv=128, D=64),
    dict(B=1, Hq=8, Hkv=2, Sq=128, Skv=128, D=64),
    dict(B=2, Hq=4, Hkv=2, Sq=96, Skv=96, D=64),
    dict(B=1, Hq=4, Hkv=4, Sq=128, Skv=128, D=64, window=32),
    dict(B=1, Hq=4, Hkv=4, Sq=128, Skv=128, D=64, softcap=30.0),
    dict(B=1, Hq=4, Hkv=2, Sq=64, Skv=192, D=64),
    dict(B=1, Hq=4, Hkv=4, Sq=100, Skv=228, D=32, window=50),
    dict(B=1, Hq=2, Hkv=1, Sq=128, Skv=128, D=128, window=64, softcap=50.0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(case, dtype):
    c = dict(case)
    B, Hq, Hkv, Sq, Skv, D = (c.pop(k) for k in ("B", "Hq", "Hkv", "Sq",
                                                 "Skv", "D"))
    rng = np.random.default_rng(Sq * 7 + Skv + D)
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    pallas = np.asarray(jfo.flash_attention(jq, jk, jv, block_q=64,
                                            block_k=64, **c), np.float32)
    oracle = np.asarray(jfr.attention_ref(jq, jk, jv, **c))
    port = fa.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), **c)
    assert port.dtype == tdt and port.shape == (B, Hq, Sq, D)
    port = port.float().numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert np.abs(port - pallas).max() < tol
    assert np.abs(port - oracle).max() < tol


def test_flash_writes_through_strides_and_refuses_more_queries_than_keys():
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 32
    q = _t(rng.normal(size=(B, S, Hq, D))).transpose(1, 2)
    k = _t(rng.normal(size=(B, S, Hkv, D))).transpose(1, 2)
    v = _t(rng.normal(size=(B, S, Hkv, D))).transpose(1, 2)
    out = torch.empty(B, S, Hq, D)
    got = fa.flash_attention(q, k, v, out=out.transpose(1, 2))
    want = fa.attention_ref(q, k, v)
    assert torch.equal(out.transpose(1, 2), got) and torch.equal(got, want)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        fa.flash_attention(k.repeat(1, 1, 2, 1), k, v)
    before = AK.launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        AK.flash_attention_cuda(q, k, v)
    assert AK.launches() == before


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,softcap", [
    (48, 32, 2, 2, 32, None),        # whisper SMOKE: decoder past 32 frames
    (100, 7, 4, 2, 16, None),
    (9, 1, 2, 1, 16, 30.0),
    (1, 50, 4, 4, 32, None),         # cross-attention at decode
])
def test_flash_plain_noncausal_with_more_queries_than_keys(Sq, Skv, Hq, Hkv,
                                                           D, softcap):
    """Non-causal attention with Sq > Skv (whisper's cross-attention over a
    shorter encoder): every query sees every key, as the JAX package's
    ``blocked_attention`` computes it; float32 at the flash limit 2e-5.
    With a causal mask or a window the case still raises."""
    from repro.models.layers import blocked_attention
    rng = np.random.default_rng(Sq * 100 + Skv)
    q = rng.normal(size=(2, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(2, Hkv, Skv, D)).astype(np.float32)
    v = rng.normal(size=(2, Hkv, Skv, D)).astype(np.float32)
    want = np.asarray(blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        softcap=softcap, block_k=16))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=False,
                             softcap=softcap)
    assert got.shape == (2, Hq, Sq, D)
    assert np.abs(got.numpy() - want).max() < 2e-5
    if Sq > Skv:
        for opts in (dict(causal=True), dict(causal=False, window=4)):
            with pytest.raises(ValueError, match="causal"):
                fa.flash_attention(_t(q), _t(k), _t(v), **opts)


@pytest.mark.parametrize("Hq,Hkv,Sq", [
    (17, 1, 1),                 # 17 rows: one past a 16-row m-tile
    (40, 8, 4),                 # 20: qwen3-14b's group at 4 new tokens
    (32, 2, 2),                 # 32: glm4-9b's 16 a kv head, 2 tokens
    (32, 2, 4),                 # 64: a whole row tile
    (13, 1, 5),                 # 65: one past a row tile
    (56, 8, 10)])               # 70: deepseek's group at 10 new tokens
@pytest.mark.parametrize("window,softcap", [(None, None), (16, 30.0)])
def test_decode_plain_at_many_query_rows_matches_the_jax_models_decode(
        Hq, Hkv, Sq, window, softcap):
    """Several new tokens a step, folded into group·Sq query rows as the
    JAX model's ``decode_attention_jnp`` folds them (no mask among the new
    tokens), at row counts around the kernel's 16-row m-tiles and 64-row
    tiles, with gemma2's window and softcap and without."""
    B, S, D = 2, 96, 32
    rng = np.random.default_rng(Hq * 100 + Sq)
    q = rng.normal(size=(B, Hq, Sq, D)) * 2.0
    k, v = (rng.normal(size=(B, Hkv, S, D)) for _ in range(2))
    L = np.asarray([S, 41], np.int32)
    want = decode_attention_jnp(
        jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(L), window=window,
        softcap=softcap)
    o, m, l = da.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(L),
                                  window=window, softcap=softcap)
    assert o.shape == (B, Hq, Sq, D) and m.shape == l.shape == (B, Hq, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=F32["o"],
                               rtol=0)


# ---------------------------------------------------------------------------
# the wrappers' host-side arithmetic (pure functions of shape and SM count)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("group,tiles", [
    (1, 1), (16, 1), (17, 1), (64, 1), (65, 2), (70, 2), (128, 2),
    (129, 3)])
def test_decode_row_tiles(group, tiles):
    """A row's query rows take blocks of up to 64 rows."""
    assert DK.row_tiles(group) == tiles
@pytest.mark.parametrize("rows,S,sms,want", [
    (64, 32768, 132, 4),        # B = 8 x 8 kv heads: one wave of 256 blocks
    (32, 512, 132, 8),          # B = 4, cache 512: eight 64-key chunks
    (32, 36, 132, 1),           # the serving loop's last step: one tile
    (6, 20000, 132, 44),
    (264, 4096, 132, 1),        # a wave of rows already
    (1000, 1, 132, 1),
    (1, 1, 132, 1),
    (1, 32768, 132, 264),
    (8, 4096, 16, 4),
])
def test_decode_split_count(rows, S, sms, want):
    n = DK.split_count(rows, S, sms)
    assert n == want
    assert 1 <= n <= -(-S // DK.TILE)
    assert rows * n <= max(rows, DK.BLOCKS_PER_SM * sms)


def test_decode_split_count_covers_every_key_and_ends_dead_splits():
    """Every split count gives chunks (rounded to the 64-key tile) that
    cover a row's live length exactly once; splits past the length are
    the ones that exit at once."""
    for S in (1, 63, 64, 65, 4096, 32768):
        for rows in (1, 6, 32, 64, 500):
            n = DK.split_count(rows, S, 132)
            for length in {0, 1, S // 2, S}:
                chunk = -(-length // n) if length else 0
                chunk = -(-chunk // DK.TILE) * DK.TILE
                spans = [(i * chunk, min(i * chunk + chunk, length))
                         for i in range(n)]
                live = [(a, b) for a, b in spans if a < b]
                assert sum(b - a for a, b in live) == length
                assert all(a % DK.TILE == 0 for a, _ in live)


def test_kernel_paths_by_type_pair():
    bf, f32 = torch.bfloat16, torch.float32
    assert DK.kernel_path(bf, bf) == "mma"
    assert DK.kernel_path(bf, f32) == DK.kernel_path(f32, bf) \
        == DK.kernel_path(f32, f32) == "fma"
    assert AK.kernel_path(bf) == "wgmma" and AK.kernel_path(f32) == "fma"
    with pytest.raises(ValueError):
        DK.kernel_path(torch.float16, bf)
    with pytest.raises(ValueError):
        AK.kernel_path(torch.float16)


H100_SMEM_PER_BLOCK = 232_448    # dynamic shared memory a block may have


@pytest.mark.parametrize("D", [32, 64, 128])
def test_shared_memory_of_every_instantiation_fits(D):
    """Each kernel instantiation's dynamic shared memory is at most the
    232,448 B a block may have, and the decode ring leaves room for the
    blocks per SM that the split count plans on (228 KB an SM, 1 KB of it
    reserved per block)."""
    types = (torch.float32, torch.bfloat16)
    for q_dt in types:
        assert 0 < AK.smem_bytes(D, q_dt) <= H100_SMEM_PER_BLOCK
        for kv_dt in types:
            assert 0 < DK.smem_bytes(D, q_dt, kv_dt) <= H100_SMEM_PER_BLOCK
    ring = DK.smem_bytes(D, torch.bfloat16, torch.bfloat16)
    assert DK.BLOCKS_PER_SM * (ring + 1024) <= 228 * 1024
    # the wgmma kernel at D = 128: 1024 B of alignment slack, the 128-row
    # Q tile, four stages of 96-key K and V tiles and nine mbarriers
    assert AK.smem_bytes(128, torch.bfloat16) == 1024 + 32768 \
        + 4 * 2 * 24576 + 9 * 8
