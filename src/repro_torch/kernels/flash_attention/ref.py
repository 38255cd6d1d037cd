"""Plain PyTorch version of blockwise (flash) attention: the whole logit
matrix at once, in float32.

Covers the variants the architecture pool needs, as the JAX package's
``kernels/flash_attention/ref.py`` does: causal masking, GQA (query heads
a multiple of kv heads), a sliding window (gemma2's local layers), tanh
logit softcapping (gemma2) and explicit kv length masking.  The CPU tests
run it; on the card ``chip_smoke.py`` holds the hand-written kernel
against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_lengths(Sq: int, Skv: int, causal: bool, window) -> None:
    """Raise unless every one of Sq ≥ 1 queries has a live key: Sq ≤ Skv,
    or unmasked attention over Skv ≥ 1 keys."""
    unmasked = not causal and window is None
    if Sq < 1 or Skv < 1 or (Sq > Skv and not unmasked):
        raise ValueError(f"flash attention needs 1 <= Sq <= Skv, or Skv >= "
                         f"1 without a causal mask or window; got Sq={Sq}, "
                         f"Skv={Skv}, causal={bool(causal)}, "
                         f"window={window}")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None,
                  kv_length: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) → (B, Hq, Sq, D) float32.

    ``window``: keys attendable iff q_pos − window < k_pos ≤ q_pos.
    ``kv_length``: (B,) valid kv prefix lengths.  Query positions are
    aligned to the *end* of the kv sequence (q_pos = Skv − Sq + i).
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = Skv - Sq + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    mask = mask[None, None].expand(s.shape)
    if kv_length is not None:
        lmask = k_pos[None, :] < kv_length.to(q.device)[:, None]   # (B, Skv)
        mask = mask & lmask[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)
