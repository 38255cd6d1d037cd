"""Public dispatch for decode attention (``cuda → plain``): GQA folding
and the combination of sequence shards.

``decode_attention`` folds the kv-head axis into the batch, as the JAX
package's ``ops.decode_attention`` does: each (batch, kv head) pair
becomes one row whose ``group`` query heads attend to that kv head.  With
several new tokens a step (q (B, Hq, Sq, D)) their queries join the row
as ``decode_attention_jnp`` folds them (``transformer.py:136`` of the JAX
package): query head g's token s is row g·Sq + s, every new token sees the
row's whole ``kv_length`` and no mask lies among them.  Tensors on a CUDA
device launch the hand-written kernel or raise; CPU tensors run the plain
PyTorch version, which is for tests.  Tensors on ``meta`` (a trace of a
step, ``repro_torch.launch.trace_analysis``) take
:func:`decode_attention_meta`.  Nothing is caught: a failed build or
launch propagates.
"""
from __future__ import annotations

import torch

from repro_torch.spans import span

from .. import _meta
from . import kernel, ref


def decode_attention_folded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_length: torch.Tensor,
                            scale: float | None = None, *,
                            window: int | None = None,
                            softcap: float | None = None):
    """The folded layout (q (R, group, D), k/v (R, S, D), kv_length (R,))
    → the partial triple: the kernel on a CUDA device, the plain version
    on the CPU.  ``window`` keeps the keys ``j > kv_length − 1 − window``;
    ``softcap`` caps the scaled scores at ``softcap·tanh(s/softcap)``."""
    if q.device.type == "meta":
        return decode_attention_meta(q, k, v, window=window)
    if q.device.type == "cuda":
        return kernel.decode_attention_cuda(q, k, v, kv_length, scale,
                                            window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_length, scale,
                                        window=window, softcap=softcap)
    raise ValueError(f"decode attention runs on CUDA or the CPU, "
                     f"not {q.device}")


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, window: int | None = None):
    """The kernel on ``meta``: the buffers its CUDA wrapper allocates (the
    triple, and the split partials where it splits a row's keys over
    blocks, sized for the card :data:`_meta.SMS` stands for) and one
    launch booked.  A meta tensor holds no lengths, so each row is booked
    at the most keys its window lets it read, ``min(S, window)``: the
    dry run decodes with the cache full, where that is the length.
    Operations 4·D a (query row, key) pair; bytes K and V of those keys,
    q read and the triple written once."""
    R, G, D = (int(n) for n in q.shape)
    S = int(k.shape[1])
    live = S if window is None else min(S, int(window))
    n_split = kernel.split_count(R * kernel.row_tiles(G), live, _meta.SMS)
    out = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((R, G, D), **out)
    m = torch.empty((R, G), **out)
    l = torch.empty((R, G), **out)
    if n_split > 1:                      # the split's partials, transient
        parts = (torch.empty((n_split, R, G, D), **out),
                 torch.empty((n_split, R, G), **out),
                 torch.empty((n_split, R, G), **out))
        del parts
    keys = R * live
    nbytes = 2 * keys * D * k.element_size() + q.numel() * q.element_size() \
        + R * G * (D + 2) * 4
    _meta.book("decode_attention", 4 * G * D * keys, nbytes)
    return o, m, l


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_length: torch.Tensor | None = None, *,
                     scale: float | None = None, window: int | None = None,
                     softcap: float | None = None):
    """q (B, Hq, Sq, D), or (B, Hq, D) for one new token; k/v (B, Hkv, S,
    D); kv_length (B,) int32 (default: S), shared by every new token →
    partial triple (o (B, Hq, Sq, D), m (B, Hq, Sq), l (B, Hq, Sq)),
    float32, without the Sq axis for a 3-D q; ``window`` and ``softcap``
    as in :func:`decode_attention_folded`.

    The span ``attn.decode`` opens here, where the kernel is launched: a
    launch made outside any aten op is tied in a profiler trace to the
    innermost span open around it, so the span starts inside any range a
    caller opens around this call."""
    with span("attn.decode"):
        one = q.dim() == 3
        if one:
            q = q[:, :, None]
        B, Hq, Sq, D = q.shape
        _, Hkv, S, _ = k.shape
        if kv_length is None:
            kv_length = torch.full((B,), S, dtype=torch.int32,
                                   device=q.device)
        rows = Hq // Hkv * Sq
        # fold kv heads into the batch and (head, token) into the row:
        # q (B·Hkv, group·Sq, D); k/v (B·Hkv, S, D)
        qg = q.reshape(B * Hkv, rows, D).contiguous()
        kg = k.reshape(B * Hkv, S, D).contiguous()
        vg = v.reshape(B * Hkv, S, D).contiguous()
        lg = kv_length.to(torch.int32).repeat_interleave(Hkv)
        o, m, l = decode_attention_folded(qg, kg, vg, lg, scale,
                                          window=window, softcap=softcap)
        shape = (B, Hq) if one else (B, Hq, Sq)
        return o.reshape(*shape, D), m.reshape(shape), l.reshape(shape)


def combine_partials(os: torch.Tensor, ms: torch.Tensor, ls: torch.Tensor):
    """Combine per-shard partial triples stacked on axis 0 (the plain
    math, as in the JAX package, where it is jnp and not a kernel)."""
    return ref.combine_partials_ref(os, ms, ls)
