"""Public dispatch for batched candidate scoring (``cuda → numpy``).

``candidate_scores`` is what the sweep engine calls.  It folds the storage
profile into affine coefficients when it can; a profile that does not
fold goes to the bit-exact float64 numpy evaluator.  ``backend="cuda"``
moves the (C, S) widths to ``device`` (the card unless named) as one
contiguous float32 tensor: a CUDA device launches the hand-written kernel
or raises, a CPU device runs the plain PyTorch version, which is for
tests.  Nothing is caught: a failed build or launch propagates.  The
device path computes in float32 — it ranks candidates, it never produces
the exact Eq. (6) costs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.latency import batched_mean_read_costs
from repro_torch.core.storage import affine_coefficients

from .._cuda import resolve_device
from . import kernel, ref

BACKENDS = ("cuda", "numpy")


def affine_scores(widths: torch.Tensor, weights: torch.Tensor, ell: float,
                  inv_bw: float) -> torch.Tensor:
    """(C, S) widths and (S,) weights on one device → (C,) scores there:
    the kernel on a CUDA device, the plain version on the CPU."""
    if widths.device.type == "cuda":
        return kernel.affine_scores_cuda(widths, weights, ell, inv_bw)
    if widths.device.type == "cpu":
        return ref.affine_scores_torch(widths, weights, ell, inv_bw)
    raise ValueError(f"candidate scoring runs on CUDA or the CPU, "
                     f"not {widths.device}")


def timed_affine_scores(widths, weights, ell: float, inv_bw: float,
                        device=None) -> tuple[np.ndarray, tuple]:
    """Score (C, S) widths on ``device`` (the card unless named) → (C,)
    float64 scores and the wall seconds of the three device steps: the
    float32 cast with the host→device copy, the launch (synchronised) and
    the readback."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    W = torch.from_numpy(np.ascontiguousarray(widths, dtype=np.float32))
    wt = torch.from_numpy(np.ascontiguousarray(weights, dtype=np.float32))
    W, wt = W.to(dev), wt.to(dev)
    t1 = time.perf_counter()
    out = affine_scores(W, wt, ell, inv_bw)
    if dev.type == "cuda":      # the readback waits for the launch anyway
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    scores = out.cpu().numpy().astype(np.float64)
    return scores, (t1 - t0, t2 - t1, time.perf_counter() - t2)


def affine_candidate_scores(widths, weights, ell: float, inv_bw: float, *,
                            backend: str = "cuda",
                            device=None) -> np.ndarray:
    """Batched ``Ê[T(Δ)]`` under an affine tier → (C,) float64."""
    if backend == "numpy":
        return ref.affine_scores_ref(widths, weights, ell, inv_bw)
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    return timed_affine_scores(widths, weights, ell, inv_bw, device)[0]


def candidate_scores(widths, weights, profile, *, backend: str = "cuda",
                     device=None) -> np.ndarray:
    """Score a (C, S) widths matrix under ``profile`` → (C,) float64.

    Affine-representable profiles take the requested backend; any other
    profile goes to numpy — the device closed form only exists for
    ``T(Δ) = ℓ + Δ/B`` tiers.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "cuda":
        co = affine_coefficients(profile)
        if co is not None:
            return affine_candidate_scores(widths, weights, *co,
                                           backend="cuda", device=device)
    return batched_mean_read_costs(widths, weights, profile)
