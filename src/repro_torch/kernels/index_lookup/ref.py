"""Plain PyTorch versions of the batched index-lookup kernels.

Semantics (the JAX package's ``repro.kernels.index_lookup.ref``):

  * step layer: rank r(q) = #{piece keys ≤ q}; covering piece
    i = max(r − 1, 0); prediction = (pos_lo[i], pos_hi[i]).
  * band layer: node j = max(#{node keys ≤ q} − 1, 0);
    mid = y1[j] + m[j]·(q − x1[j]) in float32;
    prediction = (⌊mid − δ[j]⌋, max(⌈mid + δ[j]⌉, lo + 1)).
  * segmented step: query i searches only the ``seg``-wide segment of the
    layer that starts at its ``seg_base[i]``, entries clipped at P − 1.

Keys and positions are int32, band math float32, every float32 operation
rounded on its own, so the CUDA kernels (which forbid FMA contraction)
equal these bit for bit.  They run for CPU tensors (the tests) and are
the kernels' yardstick on the card.
"""
from __future__ import annotations

import torch


def _rank_index(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """max(#{keys ≤ q} − 1, 0) per query."""
    return (torch.searchsorted(keys, queries, right=True) - 1).clamp_(min=0)


def step_lookup_torch(queries, keys, pos_lo, pos_hi):
    """queries (Q,) int32; keys (P,) int32 sorted; pos_* (P,) int32."""
    i = _rank_index(keys, queries)
    return pos_lo[i], pos_hi[i]


def band_lookup_torch(queries, keys, x1, y1, m, delta):
    """queries (Q,) int32; node keys (P,) int32 sorted; params (P,) f32."""
    j = _rank_index(keys, queries)
    mid = y1[j] + m[j] * (queries.to(torch.float32) - x1[j])
    lo = torch.floor(mid - delta[j]).to(torch.int32)
    hi = torch.ceil(mid + delta[j]).to(torch.int32)
    return lo, torch.maximum(hi, lo + 1)


def segmented_step_lookup_torch(queries, seg_base, keys, pos_lo, pos_hi,
                                seg: int = 128):
    """queries (Q,) int32; seg_base (Q,) int32 segment starts; the layer's
    keys, pos_lo, pos_hi (P,) int32 → the row-wise compare-count of the
    TPU kernel over each query's clipped segment."""
    P = keys.shape[0]
    idx = (seg_base.to(torch.int64)[:, None]
           + torch.arange(seg, device=keys.device)).clamp_(max=P - 1)
    r = (keys[idx] <= queries[:, None]).sum(dim=1)
    i = (r - 1).clamp_(min=0)
    e = idx.gather(1, i[:, None])[:, 0]
    return pos_lo[e], pos_hi[e]
