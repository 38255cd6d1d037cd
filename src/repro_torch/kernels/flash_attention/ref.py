"""Plain PyTorch version of blockwise (flash) attention: the whole logit
matrix at once, in float32.

Covers the variants the architecture pool needs, as the JAX package's
``kernels/flash_attention/ref.py`` does: causal masking, GQA (query heads
a multiple of kv heads), a sliding window (gemma2's local layers), tanh
logit softcapping (gemma2), queries at any offset into the keys and
per-row kv lengths (attention over a padded cache).  The CPU tests
run it; on the card ``chip_smoke.py`` holds the hand-written kernel
against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_lengths(Sq: int, Skv: int, causal: bool, window,
                  q_offset: int | None = None) -> None:
    """Raise unless Sq ≥ 1 queries meet Skv ≥ 1 keys.  End-aligned (no
    ``q_offset``), every query must also have a live key: Sq ≤ Skv, or
    unmasked attention.  With an explicit ``q_offset`` any placement is
    taken; a query with no live key then gets 0 (as a row of
    ``kv_length`` 0 does)."""
    unmasked = not causal and window is None
    if Sq < 1 or Skv < 1 or (q_offset is None and Sq > Skv
                             and not unmasked):
        raise ValueError(f"flash attention needs 1 <= Sq <= Skv, or Skv >= "
                         f"1 without a causal mask or window (or an "
                         f"explicit q_offset); got Sq={Sq}, Skv={Skv}, "
                         f"causal={bool(causal)}, window={window}")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None,
                  q_offset: int | None = None,
                  kv_length: torch.Tensor | None = None,
                  scale: float | None = None,
                  block_k: int | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) → (B, Hq, Sq, D) float32.

    Query i sits at position ``q_pos = q_offset + i``; ``q_offset``
    defaults to ``Skv − Sq`` (queries aligned to the *end* of the keys).
    ``window``: keys attendable iff q_pos − window < k_pos ≤ q_pos.
    ``kv_length``: (B,) valid kv prefix lengths (a padded cache).  A query
    with no live key (a row of length 0, a causal query before every key)
    gets 0.  ``block_k`` below Skv computes the same softmax online over
    kv blocks of that many keys (the JAX package's ``blocked_attention``
    order); otherwise the whole logit matrix is taken at once.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q_offset = Skv - Sq if q_offset is None else int(q_offset)
    qf = q.float() * scale
    live = live_mask(Sq, Skv, causal, window, q_offset, kv_length,
                     q.device)[:, None]                     # (B|1, 1, Sq, Skv)

    def scores(sl):
        kf = k[:, :, sl].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = live[..., sl]
        return s.masked_fill(~mask, NEG_INF), mask

    def values(sl):
        return v[:, :, sl].float().repeat_interleave(group, dim=1)

    if block_k is None or block_k >= Skv:
        s, mask = scores(slice(0, Skv))
        p = torch.softmax(s, dim=-1).masked_fill(~mask, 0.0)
        return torch.einsum("bhqk,bhkd->bhqd", p, values(slice(0, Skv)))
    m = torch.full((B, Hq, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq), device=q.device)
    acc = torch.zeros((B, Hq, Sq, D), device=q.device)
    for j0 in range(0, Skv, block_k):
        sl = slice(j0, min(j0 + block_k, Skv))
        s, mask = scores(sl)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    values(sl))
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def live_mask(Sq: int, Skv: int, causal: bool, window, q_offset: int,
              kv_length: torch.Tensor | None,
              device) -> torch.Tensor:
    """(B, Sq, Skv) bool (B = 1 without ``kv_length``): which (query,
    key) pairs attend, query i at ``q_offset + i``."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask = mask[None]
    if kv_length is not None:
        lens = kv_length.to(device=device, dtype=torch.int64)
        mask = mask & (k_pos[None, None, :] < lens[:, None, None])
    return mask
