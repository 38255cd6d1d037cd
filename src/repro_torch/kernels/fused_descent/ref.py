"""Plain versions of the fused descent kernel.

  * :func:`fused_descent_ref` — the float64 ground truth, literally the
    per-layer walk :func:`repro_torch.core.descent.descend_layers`.
  * :func:`fused_descent_torch` — plain PyTorch over the *packed* planes,
    with the kernel's semantics (int32 keys, f32 band math on the
    slack-widened δ, ``hi ≥ lo + 1`` on band rows).  It is the kernel's
    yardstick on the card and what a CPU tensor runs; every f32 operation
    is rounded on its own, so the CUDA kernel (which forbids FMA
    contraction) equals it bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.descent import descend_layers


def fused_descent_ref(layers, queries: np.ndarray):
    """Float64 (L, Q) lo/hi rows — the bit-exactness reference."""
    return descend_layers(layers, np.asarray(queries, dtype=np.uint64))


def fused_descent_torch(planes: dict, queries: torch.Tensor):
    """Packed planes (tensors, as ``ops.pack_prefix`` lays them out) and
    int32 queries on one device → (lo, hi) int32 tensors of shape (L, Q)."""
    q = queries.to(torch.int32)
    qf = q.to(torch.float32)
    keys = planes["keys"]
    los, his = [], []
    for l, kind in enumerate(planes["kinds"].tolist()):
        # rank − 1 == searchsorted-right − 1: the covering partition
        i = (torch.searchsorted(keys[l], q, right=True) - 1).clamp_(min=0)
        if kind == 1:
            x1 = planes["x1"][l][i]
            y1 = planes["y1"][l][i]
            m = planes["m"][l][i]
            d = planes["delta"][l][i]
            mid = y1 + m * (qf - x1)
            lo = torch.floor(mid - d).to(torch.int32)
            hi = torch.maximum(torch.ceil(mid + d).to(torch.int32), lo + 1)
        else:
            lo = planes["pos_lo"][l][i]
            hi = planes["pos_hi"][l][i]
        los.append(lo)
        his.append(hi)
    return torch.stack(los), torch.stack(his)
