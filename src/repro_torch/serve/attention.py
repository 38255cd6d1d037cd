"""Flash-decode over a sequence-sharded KV cache, over ``torch.distributed``.

When kv_heads < model-axis size (deepseek/qwen/llama4/grok: 8 kv heads on
a 16-way axis), the cache's *sequence* dim is sharded instead: each rank
holds a contiguous shard of every sequence and computes the partial-
softmax triple (o, m, l) over it — the port's decode kernel
(:func:`repro_torch.kernels.decode_attention.decode_attention`) on a
card, its plain version on the CPU — and the shards combine with the
numerically exact max-correction, as all-reduces:

    M = max(m);  L = Σ l·e^{m−M};  O = Σ o·l·e^{m−M} / max(L, 1e-30)

A shard past a row's length gets length 0, for which the kernel returns
``m = −1e30, l = 0``: it weighs 0.  Communication per step: 2·(B·Hq)
scalars + (B·Hq·hd) — independent of sequence length.

The combination is the decode kernel package's own
(:func:`repro_torch.kernels.decode_attention.ref.combine`), given
all-reduces as its reductions; ``combine_partials`` is the same code over
shards stacked on one device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import combine


def shard_lengths(kv_length: torch.Tensor, index: int,
                  s_local: int) -> torch.Tensor:
    """Global lengths (B,) → the live tokens of shard ``index`` of
    ``s_local``: ``clamp(kv_length − index·s_local, 0, s_local)``."""
    return (kv_length.to(torch.int32) - index * s_local).clamp(0, s_local)


def _all_reduce(op, group):
    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t
    return reduce


def flash_decode_sharded(group=None, axis: str = "model"):
    """Returns ``decode_attn(q, ck, cv, kv_length)`` for this rank.

    ``group`` is a ``DeviceMesh`` (the shards lie along its ``axis``) or a
    process group (None: the default group), whose rank order is the
    shards' order.  q (B, Hq, hd) replicated; ck/cv (B, Hkv, S_local, hd)
    this rank's contiguous sequence shard, held as its own tensor;
    kv_length (B,) global lengths.  Output (B, Hq, hd) float32, the same
    on every rank.
    """
    if hasattr(group, "get_group"):                  # a DeviceMesh
        index = group.get_local_rank(axis)
        group = group.get_group(axis)
    else:
        index = dist.get_rank(group)
    all_max = _all_reduce(dist.ReduceOp.MAX, group)
    all_sum = _all_reduce(dist.ReduceOp.SUM, group)

    def decode_attn(q, ck, cv, kv_length):
        local = shard_lengths(kv_length, index, ck.shape[2])
        o, m, l = da_ops.decode_attention(q, ck, cv, local)
        return combine(o, m, l, all_max, all_sum)[0]

    return decode_attn
