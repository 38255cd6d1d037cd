"""Public dispatch for flash attention (``cuda → plain``).

``flash_attention`` keeps the JAX package's ``ops.flash_attention``
contract: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), query i at position
``Skv − Sq + i``, causal masking, GQA, a sliding window and a softcap, the
result in q's type.  It also takes what the JAX package's jnp
``blocked_attention`` takes beyond the Pallas kernel: queries placed at
any ``q_offset`` into the keys (a chunked prefill) and a (B,) ``kv_length``
that limits each batch row's keys to ``[0, kv_length[b])`` (a padded
cache, prompts of several lengths in one batch).  A query with no live
key gets 0.  The reference pads Sq and Skv to its block sizes; the kernel
masks the ragged edges itself, so nothing is padded here.  Tensors on a
CUDA device launch the hand-written kernel or raise; CPU tensors run the
plain PyTorch version, which is for tests.  Nothing is caught: a failed
build or launch propagates.  Tensors on ``meta`` (a trace of a step,
``repro_torch.launch.trace_analysis``) take :func:`flash_attention_meta`:
the kernel's result buffer and its work booked, with no values.

End-aligned queries may outnumber keys (Sq > Skv) only without a causal
mask and a window, as the JAX package's ``blocked_attention`` allows:
every query then sees every key (whisper's cross-attention when the
decoder is longer than the encoder).  With either mask such a query's
position ``Skv − Sq + i`` can be negative and the query can have no live
key, so that case raises unless the caller places the queries with
``q_offset``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _meta
from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None,
                    q_offset: int | None = None,
                    kv_length: torch.Tensor | None = None,
                    block_k: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Flash attention with GQA/sliding-window/softcap → (B, Hq, Sq, D) in
    q's type; query i at ``q_offset + i`` (default ``Skv − Sq``), batch
    row b's keys limited to ``kv_length[b]`` when given.  End-aligned, it
    needs 1 ≤ Sq ≤ Skv, or Skv ≥ 1 with neither ``causal`` nor a
    ``window``.  ``block_k`` sets the plain version's kv blocks on the
    CPU; the kernel keeps its own tiles."""
    ref.check_lengths(q.shape[2], k.shape[2], causal, window, q_offset)
    if kv_length is not None:
        kv_length = kv_length.to(device=q.device,
                                 dtype=torch.int32).contiguous()
    if q.device.type == "meta":
        return flash_attention_meta(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, out=out)
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           scale=scale, q_offset=q_offset,
                                           kv_length=kv_length, out=out)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or the CPU, "
                         f"not {q.device}")
    res = ref.attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale, q_offset=q_offset,
                            kv_length=kv_length, block_k=block_k).to(q.dtype)
    if out is None:
        return res
    return out.copy_(res)


def live_pairs(Sq: int, Skv: int, causal: bool, window: int | None,
               q_offset: int | None = None) -> int:
    """The (query, key) pairs of one head that the mask keeps: query i at
    position ``p = q_offset + i`` (default ``Skv − Sq + i``) sees the keys
    ``j ≤ p`` (causal) and ``j > p − window`` (a window) of ``0 ≤ j <
    Skv``."""
    p = (Skv - Sq if q_offset is None else int(q_offset)) \
        + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None \
        else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         q_offset: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on ``meta``: the (B, Hq, Sq, D) result in q's type (the
    buffer the CUDA wrapper allocates when ``out`` is not given), and one
    launch booked: 4·D operations a live (query, key) pair and head, and
    q, k, v read and the result written once.  A meta tensor holds no
    values, so a call with ``kv_length`` is booked as if every row held
    all Skv keys (as the decode kernel's meta branch books a row)."""
    B, Hq, Sq, D = (int(n) for n in q.shape)
    if out is None:
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    pairs = B * Hq * live_pairs(Sq, int(k.shape[2]), causal, window,
                                q_offset)
    nbytes = 2 * q.numel() * q.element_size() \
        + (k.numel() + v.numel()) * k.element_size()
    _meta.book("flash_attention", 4 * D * pairs, nbytes)
    return out
