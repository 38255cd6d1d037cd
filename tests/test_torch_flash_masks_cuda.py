"""The flash-attention kernel with queries placed at any ``q_offset`` and
per-row ``kv_length`` (attention over a padded cache), on the card,
against its plain PyTorch version on the same inputs (torch generator
seeds).  Tolerances as in ``test_torch_kernel_cuda.py``: float32 2e-5
(the JAX flash tests' limit; float32 sums in another order, TF32 off),
bfloat16 2e-2.  A query with no live key is exactly 0.  Needs an NVIDIA
card: run there with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_flash_masks_cuda.py``; skips on a machine without one.
It imports only the port, so it runs where jax is not installed."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import kernel as AK
from repro_torch.kernels.flash_attention import ref as AR
from repro_torch.models.layers import FlashAttention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(s, generator=g, device=card).to(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


CASES = [
    # a chunked prefill: the chunk inside a longer cache
    dict(B=2, Hq=8, Hkv=2, Sq=200, Skv=1000, D=128, q_offset=300,
         lengths=(500, 500)),
    dict(B=1, Hq=4, Hkv=4, Sq=129, Skv=700, D=64, q_offset=96),
    # padded rows, causal and end-aligned, one row empty
    dict(B=4, Hq=8, Hkv=2, Sq=300, Skv=300, D=128,
         lengths=(300, 211, 97, 0)),
    # rows shorter than the queries' start: the kernel stores 0
    dict(B=3, Hq=4, Hkv=1, Sq=64, Skv=512, D=32, q_offset=448,
         lengths=(512, 450, 100)),
    # a window and a softcap with lengths
    dict(B=3, Hq=4, Hkv=2, Sq=256, Skv=1024, D=128, window=100,
         softcap=30.0, q_offset=700, lengths=(1024, 760, 640)),
    # queries before every key (causal), and past the cache
    dict(B=2, Hq=2, Hkv=1, Sq=160, Skv=96, D=64, q_offset=-64),
    dict(B=2, Hq=2, Hkv=2, Sq=40, Skv=96, D=32, q_offset=120,
         lengths=(96, 1000)),
    # non-causal with lengths (a padded encoder)
    dict(B=2, Hq=4, Hkv=2, Sq=130, Skv=200, D=64, causal=False,
         lengths=(200, 33)),
]


def _case(card, c, dtype, seed):
    c = dict(c)
    dims = [c.pop(x) for x in ("B", "Hq", "Hkv", "Sq", "Skv", "D")]
    lengths = c.pop("lengths", None)
    q, k, v = _inputs(card, seed, *dims, dtype)
    if lengths is not None:
        c["kv_length"] = torch.tensor(lengths, dtype=torch.int32,
                                      device=card)
    return q, k, v, c


def _dead_rows(q, k, c):
    """(B, Sq) bool: the queries with no live key."""
    B, _, Sq, _ = q.shape
    Skv = k.shape[2]
    off = Skv - Sq if c.get("q_offset") is None else c["q_offset"]
    live = AR.live_mask(Sq, Skv, c.get("causal", True), c.get("window"),
                        off, c.get("kv_length"), q.device)
    return ~live.expand(B, Sq, Skv).any(dim=-1)


@pytest.mark.parametrize("i", range(len(CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_and_lengths_equal_the_plain_version(card, i, dtype):
    q, k, v, c = _case(card, CASES[i], dtype, 100 + i)
    before = AK.launches()
    o = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert AK.launches() == before + 1 and o.dtype == dtype
    want = fa.attention_ref(q, k, v, **c)
    assert float((o.float() - want).abs().max()) <= TOL[dtype]
    dead = _dead_rows(q, k, c)
    assert torch.all(o.transpose(1, 2)[dead] == 0)


@pytest.mark.parametrize("wrong", ["mask", "offset", "lengths"])
def test_a_wrong_mask_fails_the_bound(card, wrong):
    """The controls of ``chip_smoke.py``: the plain version with the mask
    dropped, the offset dropped or the lengths shifted by one is outside
    the bound the kernel meets."""
    q, k, v, c = _case(card, CASES[0 if wrong == "offset" else 2],
                       torch.bfloat16, 7)
    o = fa.flash_attention(q, k, v, **c)
    bad = dict(c)
    if wrong == "mask":
        bad["kv_length"] = None
    elif wrong == "offset":
        bad["q_offset"] = None
    else:
        bad["kv_length"] = (c["kv_length"] - 1).clamp_min(0)
    want = fa.attention_ref(q, k, v, **bad)
    torch.cuda.synchronize()
    assert float((o.float() - want).abs().max()) > TOL[torch.bfloat16]


@pytest.mark.parametrize("Sq", [1, 64, 65, 127, 128, 129, 255])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_bf16_offsets_at_tile_edges(card, Sq, D):
    """The wgmma kernel's 128-query tiles (64 a warpgroup) and 96-key
    tiles against offsets and lengths that cut them anywhere."""
    B, Hq, Hkv, Skv = 3, 4, 2, 400
    q, k, v = _inputs(card, Sq * 10 + D, B, Hq, Hkv, Sq, Skv, D,
                      torch.bfloat16)
    for off in (0, 95, 96, 97, Skv - Sq):
        lens = torch.tensor([Skv, off + 1, 191], dtype=torch.int32,
                            device=card)
        o = AK.flash_attention_cuda(q, k, v, q_offset=off, kv_length=lens)
        want = fa.attention_ref(q, k, v, q_offset=off, kv_length=lens)
        torch.cuda.synchronize()
        assert float((o.float() - want).abs().max()) <= TOL[torch.bfloat16]


def test_the_wrapper_refuses_bad_lengths(card):
    q, k, v = _inputs(card, 1, 2, 2, 2, 8, 16, 32, torch.bfloat16)
    before = AK.launches()
    for lens in (torch.ones(2, dtype=torch.int64, device=card),
                 torch.ones(3, dtype=torch.int32, device=card),
                 torch.ones(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="kv_length"):
            AK.flash_attention_cuda(q, k, v, kv_length=lens)
    assert AK.launches() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_through_a_padded_cache(card, dtype):
    """``FlashAttention`` with an offset and lengths: the kernel forward,
    and the PyTorch backward against autograd through the plain version
    (over max |grad|), every query with a live key."""
    B, Hq, Hkv, Sq, Skv, D = 3, 8, 2, 192, 640, 64
    q, k, v = _inputs(card, 11, B, Hq, Hkv, Sq, Skv, D, dtype)
    do = torch.randn_like(q)
    lens = torch.tensor([640, 501, 448], dtype=torch.int32, device=card)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = AK.launches()
    out = FlashAttention.apply(q, k, v, True, None, None, None, 448, lens,
                               128)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert AK.launches() == before + 1
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_out = fa.attention_ref(*ref_in, q_offset=448, kv_length=lens)
    assert float((out.detach().float() - ref_out.detach()).abs().max()) \
        <= TOL[dtype]
    want = torch.autograd.grad(ref_out, ref_in, do.float())
    for g, w in zip(got, want):
        assert float((g.float() - w).abs().max() / w.abs().max()) \
            <= TOL[dtype]
