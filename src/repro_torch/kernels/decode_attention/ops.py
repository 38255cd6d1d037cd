"""Public dispatch for decode attention (``cuda → plain``): GQA folding
and the combination of sequence shards.

``decode_attention`` folds the kv-head axis into the batch, as the JAX
package's ``ops.decode_attention`` does: each (batch, kv head) pair
becomes one row whose ``group`` query heads attend to that kv head.
Tensors on a CUDA device launch the hand-written kernel or raise; CPU
tensors run the plain PyTorch version, which is for tests.  Nothing is
caught: a failed build or launch propagates.
"""
from __future__ import annotations

import torch

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
    if q.device.type == "cuda":
        return kernel.decode_attention_cuda(q, k, v, kv_length, scale,
                                            window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_length, scale,
                                        window=window, softcap=softcap)
    raise ValueError(f"decode attention runs on CUDA or the CPU, "
                     f"not {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_length: torch.Tensor | None = None, *,
                     scale: float | None = None, window: int | None = None,
                     softcap: float | None = None):
    """q (B, Hq, D); k/v (B, Hkv, S, D); kv_length (B,) int32 (default:
    S) → partial triple (o (B, Hq, D), m (B, Hq), l (B, Hq)), float32;
    ``window`` and ``softcap`` as in :func:`decode_attention_folded`."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    if kv_length is None:
        kv_length = torch.full((B,), S, dtype=torch.int32, device=q.device)
    group = Hq // Hkv
    # fold kv heads into the batch: q (B·Hkv, group, D); k/v (B·Hkv, S, D)
    qg = q.reshape(B * Hkv, group, D).contiguous()
    kg = k.reshape(B * Hkv, S, D).contiguous()
    vg = v.reshape(B * Hkv, S, D).contiguous()
    lg = kv_length.to(torch.int32).repeat_interleave(Hkv)
    o, m, l = decode_attention_folded(qg, kg, vg, lg, scale, window=window,
                                      softcap=softcap)
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def combine_partials(os: torch.Tensor, ms: torch.Tensor, ls: torch.Tensor):
    """Combine per-shard partial triples stacked on axis 0 (the plain
    math, as in the JAX package, where it is jnp and not a kernel)."""
    return ref.combine_partials_ref(os, ms, ls)
