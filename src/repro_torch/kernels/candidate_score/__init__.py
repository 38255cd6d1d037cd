"""Batched candidate scoring for the AirTune sweep engine: the Hopper
kernel, its plain versions and the ``cuda → numpy`` dispatch.

Evaluates the Eq. (9) ranking estimate ``Ê[T(Δ)]`` for a whole (C, S)
matrix of candidate widths in one launch, for affine-representable tiers
(:func:`repro_torch.core.storage.affine_coefficients`); any other tier
takes the bit-exact numpy evaluator.  The device path computes in float32
and is used for candidate *ranking* only.
"""
from .kernel import affine_scores_cuda
from .ops import (BACKENDS, affine_candidate_scores, affine_scores,
                  candidate_scores, timed_affine_scores)
from .ref import affine_scores_ref, affine_scores_torch

__all__ = ["BACKENDS", "affine_candidate_scores", "affine_scores",
           "affine_scores_cuda", "affine_scores_ref", "affine_scores_torch",
           "candidate_scores", "timed_affine_scores"]
