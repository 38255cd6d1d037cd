"""Plain versions of the batched affine candidate scorer.

``affine_scores_ref`` is the float64 numpy oracle (a copy of the JAX
package's); ``affine_scores_torch`` is the plain PyTorch version in
float32, the counterpart of the JAX package's jitted jnp scorer.  The
CPU tests run it, and on the card ``chip_smoke.py`` holds the
hand-written kernel against it.
"""
from __future__ import annotations

import numpy as np
import torch


def affine_scores_ref(widths, weights, ell: float, inv_bw: float) -> np.ndarray:
    """Weighted row means of ``ell + widths·inv_bw`` → (C,) float64.

    Float64 oracle for the device backends.  (The *search* default does
    not go through here — it applies the profile directly via
    ``repro_torch.core.latency.batched_mean_read_costs``, which divides by
    B exactly as the scalar path does; this closed form multiplies by the
    precomputed 1/B and is for ranking only.)
    """
    t = ell + np.asarray(widths, dtype=np.float64) * inv_bw
    return np.average(t, axis=1,
                      weights=np.asarray(weights, dtype=np.float64))


def affine_scores_torch(widths: torch.Tensor, weights: torch.Tensor,
                        ell: float, inv_bw: float) -> torch.Tensor:
    """``Σₛ (ℓ + W[c,s]·inv_bw)·wt[s] / Σₛ wt[s]`` → (C,), in the inputs'
    dtype (float32 on the device path), on the inputs' device."""
    t = ell + widths * inv_bw
    return (t * weights[None, :]).sum(dim=1) / weights.sum()
