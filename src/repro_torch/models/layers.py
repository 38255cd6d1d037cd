"""Shared building blocks of the port's transformer: norms, RoPE, blocked
attention and the gated MLP.

The JAX package computes attention in its models with jnp
(``repro.models.layers.blocked_attention``, "same semantics as
kernels.flash_attention.ref") and keeps its Pallas kernels beside them as
a drop-in.  Here the drop-in is real: ``blocked_attention`` on a CUDA
tensor is the hand-written flash-attention kernel, on a CPU tensor its
plain version.  MoE (``moe_ffn``, ``aux_load_balance_loss``) is not ported
yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + scale)`` in float32, cast back to x's type."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float = 10000.0):
    """(cos, sin) of shape (..., S, 1, d/2) for positions (..., S): the
    rotation angles :func:`rope` applies, computed once per forward."""
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding, split-halves form (not interleaved), in float32,
    cast back.  x (..., S, H, D); ``tables`` from :func:`rope_tables` for
    the positions (..., S)."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None,
                      scale: float | None = None,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) → (B, Hq, Sq, D) in q's
    type, queries end-aligned: the flash-attention kernel on the card, its
    plain version on the CPU."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, out=out)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
