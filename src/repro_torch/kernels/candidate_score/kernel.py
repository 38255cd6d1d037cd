"""Hopper kernel for batched affine candidate scoring: bind and launch.

The CUDA C++ source is ``src/repro_torch/csrc/candidate_score.cu`` (its
head comment gives the design and the bound).  It is built and loaded
through the port's one build path,
:class:`repro_torch.kernels._cuda.CudaLibrary` (nvcc for ``sm_90a`` at
first use; a failed build raises).

:func:`affine_scores_cuda` launches on PyTorch's current stream, checks
``cudaGetLastError()`` and counts every successful launch
(:func:`launches`).  Nothing here touches the card at import.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaLibrary

LIB = CudaLibrary(
    "candidate_score",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
launches = LIB.launches
reset_launches = LIB.reset_launches
build = LIB.build


def affine_scores_cuda(widths: torch.Tensor, weights: torch.Tensor,
                       ell: float, inv_bw: float) -> torch.Tensor:
    """Launch the kernel: widths (C, S) and weights (S,), contiguous
    float32 on one CUDA device → (C,) float32 scores on that device.
    Raises on anything the kernel does not take."""
    dev = widths.device
    if dev.type != "cuda":
        raise ValueError(f"affine_scores_cuda needs a CUDA tensor, got {dev}")
    if widths.dtype != torch.float32 or widths.dim() != 2 \
            or not widths.is_contiguous():
        raise ValueError(f"widths must be a contiguous (C, S) float32 "
                         f"tensor, got {widths.dtype} {tuple(widths.shape)}")
    C, S = (int(n) for n in widths.shape)
    if C < 1 or S < 1:
        raise ValueError(f"widths shape (C={C}, S={S}) unsupported: need "
                         f"C >= 1 and S >= 1")
    if weights.device != dev or weights.dtype != torch.float32 \
            or tuple(weights.shape) != (S,) or not weights.is_contiguous():
        raise ValueError(f"weights must be a contiguous float32 tensor of "
                         f"shape ({S},) on {dev}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    out = torch.empty(C, dtype=torch.float32, device=dev)
    LIB.launch(dev, widths.data_ptr(), weights.data_ptr(), C, S,
               float(ell), float(inv_bw), out.data_ptr())
    return out
