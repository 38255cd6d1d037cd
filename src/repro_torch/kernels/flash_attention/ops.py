"""Public dispatch for flash attention (``cuda → plain``).

``flash_attention`` keeps the JAX package's ``ops.flash_attention``
contract: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), query i at position
``Skv − Sq + i``, causal masking, GQA, a sliding window and a softcap, the
result in q's type.  The reference pads Sq and Skv to its block sizes; the
kernel masks the ragged edges itself, so nothing is padded here.  Tensors
on a CUDA device launch the hand-written kernel or raise; CPU tensors run
the plain PyTorch version, which is for tests.  Nothing is caught: a
failed build or launch propagates.

Queries may outnumber keys (Sq > Skv) only without a causal mask and a
window, as the JAX package's ``blocked_attention`` allows: every query
then sees every key (whisper's cross-attention when the decoder is longer
than the encoder).  With either mask such a query's position ``Skv − Sq +
i`` can be negative and the query can have no live key, so that case
raises.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Flash attention with GQA/sliding-window/softcap → (B, Hq, Sq, D) in
    q's type; needs 1 ≤ Sq ≤ Skv, or Skv ≥ 1 with neither ``causal`` nor
    a ``window`` (every query then has a live key)."""
    ref.check_lengths(q.shape[2], k.shape[2], causal, window)
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           scale=scale, out=out)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or the CPU, "
                         f"not {q.device}")
    res = ref.attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale).to(q.dtype)
    if out is None:
        return res
    return out.copy_(res)
