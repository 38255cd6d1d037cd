"""Plain PyTorch versions of decode attention (one new token against a KV
cache) and of the combination of sequence-sharded partials.

The partial-softmax triple ``(o, m, l)``, on the folded GQA layout the
kernel takes (row r is one (batch, kv head) pair with its ``group`` query
heads)::

    o — Σ_j exp(s_j − m)·v_j / l     (locally normalized output)
    m — running max of the live scores
    l — normalizer Σ_j exp(s_j − m)

With ``softcap`` the scaled scores become ``softcap·tanh(s/softcap)``, and
with ``window`` only keys ``j > kv_length − 1 − window`` stay live, as the
JAX package's ``decode_attention_jnp`` (gemma2's local layers and logit
cap).  A row of length 0 gives ``o = 0, m = −1e30, l = 0``, as the TPU kernel
``decode_attention_pallas`` does (it skips every block).  The JAX
package's ``decode_attention_ref`` masks every score of such a row instead
and returns ``l = S`` and ``o = mean(v)``; either row weighs 0 in
:func:`combine_partials_ref`.  The CPU tests run these; on the card
``chip_smoke.py`` holds the hand-written kernel against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_length: torch.Tensor, scale: float | None = None,
                         *, window: int | None = None,
                         softcap: float | None = None):
    """q (R, group, D); k/v (R, S, D) of any float type; kv_length (R,)
    int32 → (o (R, group, D), m (R, group), l (R, group)), float32."""
    R, G, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float() * scale
    s = torch.einsum("rgd,rsd->rgs", qf, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    length = kv_length.to(q.device)[:, None]
    dead = pos >= length
    if window is not None:
        dead |= pos <= length - 1 - window
    dead = dead[:, None, :]                                        # (R, 1, S)
    s = s.masked_fill(dead, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill(dead, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("rgs,rsd->rgd", p, v.float()) \
        / l.clamp_min(1e-30)[..., None]
    return o, m, l


def combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, all_max,
            all_sum):
    """The exact max-correction of partial triples, with the reductions
    over the shards passed in (``all_max``, ``all_sum``: a leading axis
    on one device, or all-reduces across ranks): M = max_i m_i;
    L = Σ_i l_i·e^(m_i − M); O = Σ_i o_i·l_i·e^(m_i − M) / L."""
    M = all_max(m)
    w = l * torch.exp(m - M)
    L = all_sum(w)
    O = all_sum(o * w[..., None]) / L.clamp_min(1e-30)[..., None]
    return O, M, L


def combine_partials_ref(os: torch.Tensor, ms: torch.Tensor,
                         ls: torch.Tensor):
    """Combine per-shard (o, m, l) triples stacked on a leading shard
    axis (:func:`combine` over that axis)."""
    O, M, L = combine(os, ms, ls, lambda t: t.amax(0, keepdim=True),
                      lambda t: t.sum(0, keepdim=True))
    return O[0], M[0], L[0]
