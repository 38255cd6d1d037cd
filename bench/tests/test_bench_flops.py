"""The FLOP and byte counts at the cells' shapes equal hand-worked
values."""
import json

import pytest

from benchlib import flops
from benchlib.guard import BENCH
from benchlib.shape import Shape


def shape(name):
    return Shape.from_config(json.loads(
        (BENCH / "configs" / f"{name}.json").read_text()))


def test_qwen3_14b_sizes():
    s = shape("qwen3-14b")
    # attention: 5120 x 128 x (40 + 16) + 40 x 128 x 5120
    assert s.attn_params() == 36_700_160 + 26_214_400
    assert s.ffn_params(True) == 3 * 5120 * 17408 == 267_386_880
    assert s.layers * s.layer_matmul_params() == 13_212_057_600
    # every weight in bf16 with the embedding and the head: 29.6 GB
    total = s.layers * s.layer_matmul_params() + 2 * 151936 * 5120 \
        + s.layers * (2 * 5120 + 2 * 128) + 5120
    assert total * 2 == pytest.approx(29.5e9, rel=0.01)


def test_qwen3_14b_prefill_flops():
    s = shape("qwen3-14b")
    S = 4096
    pairs = 4096 * 4097 // 2
    attn = 4 * 128 * 40 * pairs
    want = 40 * (2 * 330_301_440 * 4096 + attn) + 2 * 5120 * 151936
    assert flops.prefill_flops(s, S) == want
    # ~2.81e10 operations a token at 4,096
    assert flops.prefill_flops(s, S) / S == pytest.approx(2.81e10, rel=0.01)


def test_grok_1_sizes_and_decode_step():
    s = shape("grok-1")
    attn = 6144 * 128 * (48 + 16) + 48 * 128 * 6144
    expert = 3 * 6144 * 32768
    assert s.attn_params() == attn == 88_080_384
    assert s.layer_matmul_params(active=False) == attn + 8 * expert \
        + 6144 * 8
    # a layer holds 4.92 B parameters; the stage 42.6 GB with embedding
    # and head
    assert s.layer_matmul_params(active=False) == pytest.approx(4.92e9,
                                                                rel=0.01)
    B, kv = 64, 3000
    f = flops.decode_step_flops(s, B, kv)
    assert f == 64 * (4 * 2 * (attn + 2 * expert + 6144 * 8)
                      + 2 * 6144 * 131072) + 4 * 4 * 128 * 48 * 64 * kv
    b = flops.decode_step_bytes(s, B, kv)
    kvb = 4 * 2 * 64 * 8 * kv * 128 * 2
    weights = 4 * (attn + 8 * expert + 6144 * 8) + 6144 * 131072 \
        + 64 * 6144
    assert b == 2 * weights + kvb
    assert b == pytest.approx(40.97e9 + kvb, rel=0.001)
    # bytes bound the step: ~12.5 ms at 3.35 TB/s
    t, what = flops.roofline_s(b, f, 989e12, 3.35e12)
    assert what == "bytes" and t == pytest.approx(b / 3.35e12)


def test_decode_attn_bytes():
    s = shape("grok-1")
    got = flops.decode_attn_bytes(s, 64, 2049)
    want = 2 * 64 * 8 * 2049 * 128 * 2 + 64 * 48 * 128 * 2 \
        + 64 * 48 * 130 * 4
    assert got == want


def test_train_model_flops():
    s = shape("qwen3-14b").scaled(layers=14)
    B, S = 2, 4096
    n_mm = 14 * 330_301_440 + 5120 * 151936
    want = 6 * n_mm * B * S + 3 * 4 * 128 * B * 40 * S * (S + 1) // 2 * 14
    assert flops.train_model_flops(s, B, S) == want
