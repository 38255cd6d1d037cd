"""Public dispatch for flash attention (``cuda → plain``).

``flash_attention`` keeps the JAX package's ``ops.flash_attention``
contract: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), query i at position
``Skv − Sq + i``, causal masking, GQA, a sliding window and a softcap, the
result in q's type.  The reference pads Sq and Skv to its block sizes; the
kernel masks the ragged edges itself, so nothing is padded here.  Tensors
on a CUDA device launch the hand-written kernel or raise; CPU tensors run
the plain PyTorch version, which is for tests.  Nothing is caught: a
failed build or launch propagates.  Tensors on ``meta`` (a trace of a
step, ``repro_torch.launch.trace_analysis``) take :func:`flash_attention_meta`:
the kernel's result buffer and its work booked, with no values.

Queries may outnumber keys (Sq > Skv) only without a causal mask and a
window, as the JAX package's ``blocked_attention`` allows: every query
then sees every key (whisper's cross-attention when the decoder is longer
than the encoder).  With either mask such a query's position ``Skv − Sq +
i`` can be negative and the query can have no live key, so that case
raises.
"""
from __future__ import annotations

import torch

from .. import _meta
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
    if q.device.type == "meta":
        return flash_attention_meta(q, k, v, causal=causal, window=window,
                                    out=out)
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


def _sum_min(lo: int, hi: int, cap: int) -> int:
    """Σ min(x, cap) over the integers lo ≤ x ≤ hi."""
    if hi < lo:
        return 0
    top = min(hi, cap)
    below = (lo + top) * (top - lo + 1) // 2 if top >= lo else 0
    return below + cap * max(hi - max(cap, lo - 1), 0)


def live_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs of one head that the mask keeps, in closed
    form: query i at position ``p = Skv − Sq + i`` sees the keys ``j ≤ p``
    (causal) and ``j > p − window`` (a window) of ``0 ≤ j < Skv``."""
    if causal:                          # min(p + 1, window) keys each
        cap = Skv if window is None else window
        return _sum_min(Skv - Sq + 1, Skv, cap)
    if window is None:
        return Sq * Skv
    # min(Skv, Skv + window − 1 − p) keys each
    return _sum_min(window, window + Sq - 1, Skv)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on ``meta``: the (B, Hq, Sq, D) result in q's type (the
    buffer the CUDA wrapper allocates when ``out`` is not given), and one
    launch booked: 4·D operations a live (query, key) pair and head, and
    q, k, v read and the result written once."""
    B, Hq, Sq, D = (int(n) for n in q.shape)
    if out is None:
        out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    pairs = B * Hq * live_pairs(Sq, int(k.shape[2]), causal, window)
    nbytes = 2 * q.numel() * q.element_size() \
        + (k.numel() + v.numel()) * k.element_size()
    _meta.book("flash_attention", 4 * D * pairs, nbytes)
    return out
